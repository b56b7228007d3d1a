"""C4CAM on PyTorch and CUDA: the compiler's main path for one NVIDIA GPU.

This package mirrors the JAX package ``repro`` module for module
(``repro_torch/<path>`` is the counterpart of ``repro/<path>``) and is
tested against it on the same inputs.  It imports ``torch`` and never
``jax`` or anything of ``repro``.

Ported so far: the compiler front end and pass pipeline
(:mod:`repro_torch.core`), the ``SearchPlan`` top-k engine with its
``"torch"`` (eager, reference-tiled) and ``"cuda"`` (hand-written
Hopper kernels) backends, the cost model (:mod:`repro_torch.camsim`),
span tracing (:mod:`repro_torch.obs`) and the synthetic datasets
(:mod:`repro_torch.data`).  The CUDA kernels under
``repro_torch/kernels/csrc`` are compiled with ``nvcc`` at their first
launch, never at import.
"""
