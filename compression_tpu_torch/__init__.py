"""PyTorch/CUDA port of compression_tpu (learned image compression).

The JAX package ``compression_tpu`` is the reference; this package carries
the bls2017 native-container serving path to PyTorch, with the range coder's
two hot kernels hand-written in CUDA C++ for Hopper (``codec/csrc``).  It
never imports JAX or the JAX package.
"""
