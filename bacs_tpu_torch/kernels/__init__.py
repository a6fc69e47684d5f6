"""Hand-written Hopper kernels: the nvcc build of ``csrc/`` (``build.py``)."""
