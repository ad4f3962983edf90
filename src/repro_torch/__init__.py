"""PyTorch/CUDA port of the Heta reproduction.

A second package beside the JAX reference (``repro``): same layout and
names, PyTorch inside, and a hand-written CUDA kernel for Hopper in place
of every Pallas TPU kernel on the paths ported so far.  It imports nothing
of the reference package and no JAX.  Entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
