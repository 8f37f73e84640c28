"""PyTorch/CUDA port of compression_tpu (learned image compression).

The JAX package ``compression_tpu`` is the reference; this package carries
its serving paths to PyTorch slice by slice: the bls2017 and bmshj2018
codecs on the native and the classic (.tfci) containers, their entropy
models and the range coder front end, with the range coder's kernels
hand-written in CUDA C++ for Hopper (``codec/csrc``).  It never imports
JAX or the JAX package.
"""
