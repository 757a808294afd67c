"""End-to-end LM training driver, the twin of ``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset 100m

Trains a reduced-geometry model of an assigned arch's family on the
synthetic affine-next-token stream (the loss falls), with checkpoints and
exact resume: the ``cpu-small`` preset and a checkpoint directory unless
the arguments name them.  A thin wrapper over ``repro_torch.launch.train``,
so the example and the launcher share every code path.  The default
checkpoint directory, ``train_lm_ckpt``, is relative to the working
directory.
"""
import sys

from repro_torch.launch.train import main


def run(argv: list[str]) -> list[dict]:
    argv = list(argv)
    if "--preset" not in " ".join(argv):
        argv += ["--preset", "cpu-small"]
    if "--ckpt-dir" not in " ".join(argv):
        argv += ["--ckpt-dir", "train_lm_ckpt"]
    return main(argv)


if __name__ == "__main__":
    run(sys.argv[1:])
