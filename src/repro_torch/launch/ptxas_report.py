"""ptxas's report of every kernel of one tree's CUDA sources, saved to a
file; or two such files compared kernel by kernel.

For holding a kernel change against its parent commit on one card, beside
``bitwise_outputs.py``: a change that must leave the f32 and f64 builds as
they were leaves each of their kernels' register, spill, barrier and
shared-memory lines as they were.  Run this file (by its path: the parent
need not have it) with ``--save`` once with each commit's ``src`` on
``PYTHONPATH`` (it builds that tree's ``csrc`` into that tree's build
directory), then ``--compare`` the two files.  Kernel names are compared
with the anonymous namespace's two hashes taken out (one a build, one of
the source's contents, so that an edited source's unedited kernels still
pair up).

Run on a machine with ``nvcc``, from the repository root:
    PYTHONPATH=<commit>/src python src/repro_torch/launch/ptxas_report.py \\
        --save a.json
    python src/repro_torch/launch/ptxas_report.py --compare a.json b.json
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
_SOURCE = re.compile(r"(_GLOBAL__N__(?:\d+_)?\w+?_cu_)[0-9a-f]{8}")


def _name(name: str) -> str:
    """A kernel's name without the anonymous namespace's hashes: the
    build's, then the source's."""
    return _SOURCE.sub(r"\1", _ANON.sub("_GLOBAL__N__", name))


def report() -> dict:
    """{source:kernel: [ptxas lines]} of a fresh build of the tree on the
    path (a built library is kept: delete the build directory first for a
    full report)."""
    from repro_torch.kernels.gram import _build
    out, name = {}, None
    for source, text in _build.build_all()["log"].items():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = _name(m.group(1))
            elif name and re.search(r"registers|spill|smem", line):
                out.setdefault(f"{source}:{name}", []).append(
                    re.sub(r"^.*ptxas info\s*:\s*", "", line.strip()))
    return out


def compare(a: dict, b: dict) -> bool:
    """Prints each kernel whose lines differ or that one side lacks;
    True when every kernel of ``a`` has ``b``'s lines."""
    same = [k for k in a if k in b and a[k] == b[k]]
    differ = [k for k in a if k in b and a[k] != b[k]]
    gone = [k for k in a if k not in b]
    new = [k for k in b if k not in a]
    print(f"{len(same)} kernels equal, {len(differ)} differ, {len(gone)} "
          f"only in the first, {len(new)} only in the second")
    for k in differ:
        print(f"differ {k}: {a[k]} -> {b[k]}")
    for k in gone:
        print(f"only in the first: {k}")
    for k in new:
        print(f"only in the second: {k} {b[k]}")
    return not differ and not gone


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", metavar="PATH")
    ap.add_argument("--compare", nargs=2, metavar="PATH")
    args = ap.parse_args(argv)
    if args.save:
        rep = report()
        Path(args.save).write_text(json.dumps(rep, indent=0))
        print(f"saved {len(rep)} kernels to {args.save}")
    if args.compare:
        a, b = ({_name(k): v for k, v in json.loads(Path(p).read_text())
                 .items()} for p in args.compare)
        return 0 if compare(a, b) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
