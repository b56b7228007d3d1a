"""C4CAM on PyTorch and CUDA: the compiler's main path for one NVIDIA GPU.

This package mirrors the JAX package ``repro`` module for module
(``repro_torch/<path>`` is the counterpart of ``repro/<path>``) and is
tested against it on the same inputs.  It imports ``torch`` and never
``jax`` or anything of ``repro``.

Ported so far: the compiler front end and pass pipeline
(:mod:`repro_torch.core`), the ``SearchPlan`` top-k and ``RangePlan``
engines with their ``"torch"`` (eager, reference-tiled) and ``"cuda"``
(hand-written Hopper kernels) backends and incremental gallery mutation
(``update_rows``), the IR interpreter, decision forests
(:mod:`repro_torch.forest`), HDC encoding and classification
(:mod:`repro_torch.hdc`), the cost model (:mod:`repro_torch.camsim`),
span tracing (:mod:`repro_torch.obs`), the synthetic datasets
(:mod:`repro_torch.data`), and the LM side's dense family: configs
(:mod:`repro_torch.configs`), the model (:mod:`repro_torch.models`) and
the serving loop (:mod:`repro_torch.launch.serve`).  The CUDA kernels under
``repro_torch/kernels/csrc`` are compiled with ``nvcc`` at their first
launch, never at import.
"""
