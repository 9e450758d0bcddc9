"""Serving layer of the port (counterpart of ``mfm_tpu/serve``).

Two guard surfaces protect the two directions of the serving stack:

- the MODEL side — :mod:`mfm_tpu_torch.serve.guard`'s per-date health
  checks run on every appended slab before a date may enter the carries
  (quarantine + staleness-stamped degraded covariance, behind
  ``RiskModel.update_guarded``);
- the REQUEST side — :mod:`mfm_tpu_torch.serve.server`'s host-side request
  guards, admission control, deadlines, load shedding and circuit breaker
  around :mod:`mfm_tpu_torch.serve.query`'s batched engine.

:mod:`mfm_tpu_torch.serve._checks` holds the formula primitives both guard
layers share (MAD outliers, reason-bitmask plumbing).

The fleet layer stacks on top of the single loop:
:mod:`mfm_tpu_torch.serve.cache` answers repeated request bodies from a
bounded content-addressed response cache fenced on checkpoint generation +
scenario spec hash, :mod:`mfm_tpu_torch.serve.coalesce` merges concurrent
submissions into the bucket ladder under a linger budget,
:mod:`mfm_tpu_torch.serve.frontend` accepts concurrent socket/HTTP
connections, :mod:`mfm_tpu_torch.serve.replica` runs N worker processes
behind the fenced checkpoint store, and
:mod:`mfm_tpu_torch.serve.transport` carries the worker wire protocol over
deadline-bearing pipe/TCP transports, so the fleet spans hosts and
survives wedged workers.
"""

from mfm_tpu_torch.serve.guard import (  # noqa: F401
    REASON_CAP_NONPOS,
    REASON_DATE_ORDER,
    REASON_FORCED,
    REASON_NAN_DENSITY,
    REASON_RET_OUTLIER,
    REASON_UNIVERSE_COLLAPSE,
    GuardReport,
    guard_ring_init,
    guard_slab,
    host_date_reasons,
    reason_names,
)
from mfm_tpu_torch.serve.query import (  # noqa: F401
    QueryEngine,
    QueryOutputs,
    bucket_for,
)
from mfm_tpu_torch.serve.server import (  # noqa: F401
    CircuitBreaker,
    QueryServer,
    ServePolicy,
    parse_request,
    req_reason_names,
)
from mfm_tpu_torch.serve.cache import (  # noqa: F401
    CacheFill,
    ResponseCache,
    WarmStartIndex,
    cacheable_response,
)
from mfm_tpu_torch.serve.coalesce import Coalescer  # noqa: F401
from mfm_tpu_torch.serve.frontend import SocketFrontend  # noqa: F401
from mfm_tpu_torch.serve.replica import (  # noqa: F401
    FleetServer,
    Replica,
    ReplicaDeadError,
    ReplicaWedgedError,
    run_worker,
)
from mfm_tpu_torch.serve.transport import (  # noqa: F401
    PipeTransport,
    TcpTransport,
    TransportClosed,
    TransportError,
    TransportTimeout,
    serve_worker_socket,
)
