"""fm3dgan_torch: the PyTorch/CUDA port of fm3dgan for NVIDIA Hopper.

Plain tensor code is PyTorch in NCHW; the kernels the JAX package wrote in
Pallas for the TPU are hand-written CUDA kernels (``ops/csrc``), built with
``nvcc`` at first use.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
