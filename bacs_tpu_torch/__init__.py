"""BACS in PyTorch for NVIDIA Hopper: a port of the JAX package ``bacs_tpu``.

The JAX package stays the reference.  Modules here keep its file and class
names, so each has an obvious counterpart, and the public functions keep its
NHWC layout; inside the network tensors are NCHW in ``torch.channels_last``
memory.  Every Pallas kernel on a ported path has a hand-written Hopper
kernel (Triton or CUDA C++ under ``csrc/``) beside a plain PyTorch version:
a wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors.  The package imports neither ``jax`` nor ``flax``.

Ported: serving and its ``torch.export`` program (``serve.Predictor``,
``export``, ``run_exported``); every method's train step and the eval step
(``train/step.py``); the continual trainer and its command line (``python
-m bacs_tpu_torch.main``, ``train/loop.py``) with the OOD pass
(``train/ood.py``) and the media, prototype and drift loggers (``viz/``);
data parallelism across devices (``parallel/``, one process a rank).  What
exists only for the TPU or its host is not ported (ROADMAP.md).
"""

__version__ = "0.1.0"
