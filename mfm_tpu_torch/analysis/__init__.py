"""mfm_tpu_torch.analysis — static analysis of the port (counterpart of
``mfm_tpu/analysis/``).

- :mod:`~mfm_tpu_torch.analysis.sync` — mfmsync, the lock-discipline pass
  over the serving fleet's threads (stdlib only).
- the IR audit, one layer below ``lint``: ``audit`` runs every registered
  entry point (:mod:`~mfm_tpu_torch.analysis.registry`) once on a small
  fixed config matrix under probes that cost nothing when no audit
  listens, and five passes read that run —

  - A1 ``aliasing``    no operand outside the donation contract is
                       written in place or handed back as an output
  - A2 ``ir``          float64 leaks, int64 at signature boundaries, host
                       reads (what stops a CUDA graph)
  - A3 ``collectives`` what ``parallel/mesh.py``'s collectives move under
                       the doctrine mesh
  - A4 ``surface``     recompile-surface enumeration (bucket-ladder
                       signatures; runs nothing)
  - A5 ``budgets``     memory budgets on the card against
                       ``mfm_tpu_torch/tools/audit_budgets.json``

Entry points: :data:`~mfm_tpu_torch.analysis.registry.REGISTRY`,
:func:`~mfm_tpu_torch.analysis.run.run_audit` (tests and the CLI),
``python -m mfm_tpu_torch.cli audit`` and ``doctor --audit``.
"""

#: the registry's names this package exports, loaded on first use so that
#: importing ``analysis.sync`` (stdlib only) loads none of the audit
_REGISTRY_EXPORTS = ("AUDIT_MATRIX", "Cell", "Entrypoint", "Finding",
                     "NON_ENTRYPOINT", "REGISTRY", "registry_by_name")


def __getattr__(name):
    if name == "run_audit":
        from mfm_tpu_torch.analysis.run import run_audit

        return run_audit
    if name in _REGISTRY_EXPORTS:
        from mfm_tpu_torch.analysis import registry

        return getattr(registry, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
