"""BACS in PyTorch for NVIDIA Hopper: a port of the JAX package ``bacs_tpu``.

The JAX package stays the reference.  Modules here keep its file and class
names, so each has an obvious counterpart, and the public functions keep its
NHWC layout; inside the network tensors are NCHW in ``torch.channels_last``
memory.  Every Pallas kernel on a ported path has a hand-written Hopper
kernel (Triton or CUDA C++ under ``csrc/``) beside a plain PyTorch version:
a wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors.  The package imports neither ``jax`` nor ``flax``.

Ported so far: the serving path (``serve.Predictor``).
"""

__version__ = "0.1.0"
