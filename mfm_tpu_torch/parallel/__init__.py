"""Device-mesh construction and sharding specs for the pipeline
(counterpart of ``mfm_tpu/parallel/``).

The reference's serial axes (dates for the cross-sections and the eigen
Monte-Carlo, stocks for the rolling windows) are the axes this package
shards over a ``('date', 'stock')`` mesh of devices.
"""

from mfm_tpu_torch.parallel.mesh import (
    PIPELINE_SPECS,
    make_mesh,
    panel_sharding,
    replicated,
    shard_panel,
)

__all__ = [
    "make_mesh",
    "panel_sharding",
    "replicated",
    "shard_panel",
    "PIPELINE_SPECS",
]
