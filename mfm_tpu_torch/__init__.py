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
- :mod:`mfm_tpu_torch.config`  — ``RiskModelConfig``
- :mod:`mfm_tpu_torch.ops`     — masked cross-sections, batched Jacobi eigh,
                                 the constrained WLS regression
- :mod:`mfm_tpu_torch.models`  — Newey-West, eigenfactor adjustment,
                                 vol-regime adjustment, ``RiskModel``
- :mod:`mfm_tpu_torch.convert` — reference config / numpy panels -> port
- :mod:`mfm_tpu_torch.data`    — seeded synthetic panels
"""

from mfm_tpu_torch.config import RiskModelConfig
from mfm_tpu_torch.models.risk_model import RiskModel, RiskModelOutputs

__version__ = "0.1.0"

__all__ = ["RiskModel", "RiskModelConfig", "RiskModelOutputs"]
