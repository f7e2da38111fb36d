"""repro_torch: the PyTorch/CUDA port of the ``repro`` package for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``repro`` is the reference each module here is held
against; module and function names follow it so a reader can find each
counterpart.  This package imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``repro``.

Ported so far: continuous-batching serving of the dense-attention
families (``serving.engine.ServeEngine``), with two kernels written by
hand in CUDA C++ (``csrc/``): flash-attention prefill and paged-attention
decode.  Each kernel's wrapper runs its plain PyTorch version only for
CPU tensors; for a CUDA tensor it launches the kernel or raises.
"""
