"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Laid out module for module like the JAX package:
    repro_torch.core     -- CSR, schedule, SpGEMM algorithms, recipe, planner
    repro_torch.kernels  -- hand-written CUDA kernels (hash SpGEMM)
    repro_torch.data     -- R-MAT generators

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; CUDA kernels are compiled at first use, never at import.
"""

__version__ = "0.1.0"
