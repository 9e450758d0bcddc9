"""mfm_tpu_torch.analysis — static analysis of the port (counterpart of
``mfm_tpu/analysis/``).

- :mod:`~mfm_tpu_torch.analysis.sync` — mfmsync, the lock-discipline pass
  over the serving fleet's threads (stdlib only).

The reference's IR passes (donation aliasing, dtype leaks, collectives,
the recompile surface, memory budgets) and ``audit`` lower jaxprs and read
XLA's alias tables; their torch analogs are ROADMAP.md §A 22.
"""
