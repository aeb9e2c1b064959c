"""PyTorch + CUDA port of the OFDM/LTE loopback chain.

The JAX package ``lte_gnu_radio_code_tpu`` beside it is the reference; each
module here sits under the same relative path as its JAX counterpart.  The
four TPU kernels of the chain are hand-written CUDA kernels under ``csrc/``,
bound by the wrappers in ``kernels/`` (each with a plain PyTorch twin that
runs for CPU tensors).  This package never imports JAX.
"""
