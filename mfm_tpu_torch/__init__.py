"""mfm_tpu_torch — the PyTorch/CUDA port of the mfm_tpu risk model.

The port keeps the JAX package's module paths and names, so each function
has a counterpart at the same place: ``mfm_tpu/ops/xreg.py`` ->
``mfm_tpu_torch/ops/xreg.py`` and so on.  It imports neither JAX nor
anything of ``mfm_tpu``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; on a CUDA tensor the two Jacobi eigh
kernels of ``ops/eigh_cuda.py`` run (hand-written for Hopper in
``csrc/jacobi_eigh_warp.cu`` for float32 at n <= 46, in
``csrc/jacobi_eigh.cu`` otherwise), on a CPU tensor their plain PyTorch
versions.

Layout
------
- :mod:`mfm_tpu_torch.config`  — ``RiskModelConfig``, ``QuarantinePolicy``
- :mod:`mfm_tpu_torch.ops`     — masked cross-sections, batched Jacobi eigh,
                                 the constrained WLS regression
- :mod:`mfm_tpu_torch.models`  — Newey-West, eigenfactor adjustment,
                                 vol-regime adjustment, ``RiskModel`` and
                                 its resumable ``RiskModelState``
- :mod:`mfm_tpu_torch.serve`   — the daily serving step's input guards
- :mod:`mfm_tpu_torch.convert` — reference config / numpy panels / states
                                 -> port, and results back
- :mod:`mfm_tpu_torch.data`    — seeded synthetic panels, fenced npz
                                 checkpoints
"""

from mfm_tpu_torch.config import QuarantinePolicy, RiskModelConfig
from mfm_tpu_torch.models.risk_model import (
    RiskModel,
    RiskModelOutputs,
    RiskModelState,
)

__version__ = "0.1.0"

__all__ = ["QuarantinePolicy", "RiskModel", "RiskModelConfig",
           "RiskModelOutputs", "RiskModelState"]
