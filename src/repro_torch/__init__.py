"""repro_torch: the PyTorch/CUDA port of the ``repro`` package for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``repro`` is the reference each module here is held
against; module and function names follow it so a reader can find each
counterpart.  This package imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``repro``.

Ported so far: the ``api`` entry point (``RunSpec`` -> ``TrainSession``
/ ``ServeSession``, with checkpoint and resume in the JAX package's
format and hot reload), data-parallel training of the dense families
over peers stacked on one card with the OptINC collective at every
fidelity, the in-network ONN and its training, and continuous-batching
serving.  Six kernels are written by hand in CUDA C++ (``csrc/``):
flash-attention forward and backward, paged-attention decode, pam4
encode and decode, ``onn_layer`` and ``mesh_scan``.  Each kernel's
wrapper runs its plain PyTorch version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.
"""
