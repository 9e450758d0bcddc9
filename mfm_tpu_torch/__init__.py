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
- :mod:`mfm_tpu_torch.config`   — ``FactorConfig``, ``RollingSpec``,
                                  ``RiskModelConfig``, ``QuarantinePolicy``,
                                  ``PipelineConfig``
- :mod:`mfm_tpu_torch.panel`    — the dense masked ``Panel``
- :mod:`mfm_tpu_torch.ops`      — masked cross-sections, rolling-window
                                  scans, batched Jacobi eigh, the
                                  constrained WLS regression
- :mod:`mfm_tpu_torch.factors`  — the 16 sub-factors, post-processing and
                                  the row-space ``FactorEngine``
- :mod:`mfm_tpu_torch.models`   — Newey-West, eigenfactor adjustment,
                                  vol-regime adjustment, ``RiskModel`` and
                                  its resumable ``RiskModelState``; specific
                                  risk and the bias statistics
- :mod:`mfm_tpu_torch.pipeline` — raw panel -> factors -> barra table;
                                  barra table -> risk model -> result
                                  tables, analytics and the daily append
- :mod:`mfm_tpu_torch.serve`    — the daily serving step's input guards;
                                  the batched query engine, its request
                                  loop, response cache and coalescer
- :mod:`mfm_tpu_torch.scenario` — batched stress scenarios, their
                                  replay and counterfactual resolvers,
                                  manifests, and the streaming sweep
- :mod:`mfm_tpu_torch.grad`     — differentiable risk: reverse stress,
                                  exact sensitivities, portfolio
                                  construction
- :mod:`mfm_tpu_torch.alpha`    — the alpha-expression DSL, scorecards,
                                  de-correlated selection, LLM-output
                                  extraction
- :mod:`mfm_tpu_torch.obs`      — the serving stack's metrics, spans and
                                  flight recorder
- :mod:`mfm_tpu_torch.parallel` — the ('date', 'stock') device mesh, its
                                  sharded panels and collectives, and the
                                  multi-process helpers
- :mod:`mfm_tpu_torch.convert`  — reference configs / numpy panels / states
                                  -> port, and results back
- :mod:`mfm_tpu_torch.data`     — barra-table ingest, seeded synthetic
                                  market panels, risk panels and tables,
                                  fenced npz checkpoints

Nothing here needs pandas; only the DataFrame forms of the pipeline's
result tables import it, when called.
"""

from mfm_tpu_torch.config import (
    FactorConfig,
    PipelineConfig,
    QuarantinePolicy,
    RiskModelConfig,
    RollingSpec,
)
from mfm_tpu_torch.factors.engine import FactorEngine
from mfm_tpu_torch.models.risk_model import (
    RiskModel,
    RiskModelOutputs,
    RiskModelState,
)
from mfm_tpu_torch.pipeline import (
    RiskPipelineResult,
    append_risk_pipeline,
    run_factor_pipeline,
    run_risk_pipeline,
    save_pipeline_state,
)
from mfm_tpu_torch.scenario import ScenarioEngine, ScenarioSpec, SweepEngine
from mfm_tpu_torch.serve import (
    Coalescer,
    QueryEngine,
    QueryServer,
    ResponseCache,
    ServePolicy,
)

__version__ = "0.1.0"

__all__ = ["Coalescer", "FactorConfig", "FactorEngine", "PipelineConfig",
           "QuarantinePolicy", "QueryEngine", "QueryServer", "ResponseCache",
           "RiskModel", "RiskModelConfig", "RiskModelOutputs",
           "RiskModelState", "RiskPipelineResult", "RollingSpec",
           "ScenarioEngine", "ScenarioSpec", "ServePolicy", "SweepEngine",
           "append_risk_pipeline", "run_factor_pipeline",
           "run_risk_pipeline", "save_pipeline_state"]
