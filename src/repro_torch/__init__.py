"""PyTorch / CUDA port of the incremental-analytics serving system.

A second package beside ``repro`` (the JAX reference, kept unchanged).  It
imports ``torch`` and never ``jax`` or anything of ``repro``; each module
mirrors its ``repro`` counterpart's name.  Entry points run on the CUDA
device unless the caller asks for the CPU.  The hot-path attention kernels
are hand-written CUDA C++ for Hopper (``kernels/*/csrc``); on a CPU tensor
every kernel wrapper runs its plain PyTorch version instead.
"""
