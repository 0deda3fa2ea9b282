"""PyTorch/CUDA port of ``anemoi_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports nothing of
it (nor JAX) and keeps its own copies of what it needs.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
