"""repro_torch -- the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

Communication-avoiding primal and dual block coordinate descent (CA-BCD,
CA-BDCD) for ridge regression, and the CG / TSQR / CholeskyQR baselines.
Plain tensor code is PyTorch; the Gram-packet kernels are hand-written CUDA
(``csrc/``), built with ``nvcc`` at first use.  Entry points run on the device of their tensors, on the card by
default.
"""
