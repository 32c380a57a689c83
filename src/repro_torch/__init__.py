"""PyTorch/CUDA port of the reduced-precision streaming-SpMV PPR system.

The JAX package ``repro`` is the reference; this package mirrors its module
paths and public names and never imports it.  Raw Qm.f values are int32
tensors holding uint32 bits (``core.fixed_point``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the hand-written kernels
live in ``kernels`` (sources in ``csrc/``, built with nvcc at first use).
"""
