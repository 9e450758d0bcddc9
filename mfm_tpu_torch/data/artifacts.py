"""Fenced npz checkpoints (counterpart of ``mfm_tpu/data/artifacts.py``).

An artifact is a flat dict of numpy arrays plus JSON metadata in one
``.npz``.  :func:`save_artifact` stamps a sha256 of the payload into the
metadata and writes tmp -> fsync -> rename -> directory fsync, so a kill at
any byte leaves the old file or the new one.  A fenced save also stamps a
monotonically increasing ``generation`` and then swaps the directory's
``latest.json`` pointer; :func:`load_artifact` refuses a generation older
than the pointer (:class:`ArtifactStaleError`) and heals the pointer
forward when the file is one generation newer (the writer died between
rename and swap).

The risk-state format is the reference's, key for key: the Newey-West
carry as ``nw_*`` (per-lag tuples stacked to ``(q, ...)``), ``vr_num`` /
``vr_den``, ``sim_covs`` or else the ``eig_*`` quartet of the incremental
mode, the ``guard_*`` leaves of a guarded state, and the stamp and counts
in the JSON meta.  A state saved by either package loads in the other.

The reference's telemetry counters and chaos-injection points on these
paths are not ported here (ROADMAP.md §A 15).
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
import zlib
from typing import Mapping

import numpy as np
import torch

from mfm_tpu_torch._device import resolve_device

FORMAT_VERSION = 1

#: per-directory fencing pointer: ``{basename: {"generation": g,
#: "sha256": file-digest}}``, swapped atomically AFTER the artifact rename
POINTER_NAME = "latest.json"


class ArtifactCorruptError(RuntimeError):
    """An artifact file exists but cannot be trusted: truncated or corrupt
    npz (a torn write) or a checksum mismatch."""


class ArtifactStaleError(RuntimeError):
    """Fencing refusal: the artifact's generation is older than the
    directory's ``latest.json`` pointer.  ``force=True`` loads it anyway."""


def _payload_sha256(payload: Mapping[str, np.ndarray]) -> str:
    """Digest of the array payload (name, dtype, shape and bytes, in name
    order), stored inside the npz meta."""
    h = hashlib.sha256()
    for k in sorted(payload):
        a = np.ascontiguousarray(payload[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_dir(dirname: str) -> None:
    """Durably record a rename: fsync of the file alone does not persist
    the directory entry pointing at it."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _pointer_path(path: str) -> str:
    return os.path.join(os.path.dirname(path) or ".", POINTER_NAME)


def read_pointer(path: str) -> dict | None:
    """The ``latest.json`` entry for ``path`` (None when absent or
    unreadable; the artifact's own checksum still protects it)."""
    try:
        with open(_pointer_path(path)) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return None
    entry = table.get(os.path.basename(path))
    return entry if isinstance(entry, dict) else None


def _swap_pointer(path: str, generation: int, sha256: str) -> None:
    """Atomically advance the fencing pointer for ``path``: read-modify-
    write of the whole table through tmp + fsync + rename."""
    ptr = _pointer_path(path)
    try:
        with open(ptr) as f:
            table = json.load(f)
        if not isinstance(table, dict):
            table = {}
    except (OSError, ValueError):
        table = {}
    table[os.path.basename(path)] = {
        "generation": int(generation), "sha256": sha256,
    }
    tmp = ptr + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=0, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, ptr)
    _fsync_dir(os.path.dirname(ptr))


def save_artifact(path: str, arrays: Mapping[str, object],
                  meta: dict | None = None, *, fenced: bool = False):
    """Persist a flat dict of arrays (+ JSON-able metadata) atomically;
    ``fenced`` stamps the next generation and swaps ``latest.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    meta = dict(meta or {})
    meta["sha256"] = _payload_sha256(payload)
    generation = None
    if fenced:
        entry = read_pointer(path)
        generation = (int(entry["generation"]) if entry
                      and isinstance(entry.get("generation"), int) else 0) + 1
        meta["generation"] = generation
    payload["__meta__"] = np.frombuffer(
        json.dumps({"format": FORMAT_VERSION, **meta}).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"  # savez appends .npz unless already present
    try:
        np.savez_compressed(tmp, **payload)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    file_sha = _file_sha256(tmp)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    if fenced:
        _swap_pointer(path, generation, file_sha)


def load_artifact(path: str, *, fenced: bool = False, force: bool = False):
    """Returns ``(arrays dict, meta dict)``.

    A truncated or corrupt npz raises :class:`ArtifactCorruptError`, as
    does a payload-checksum mismatch (``force`` never overrides that).
    With ``fenced``, a generation older than ``latest.json`` raises
    :class:`ArtifactStaleError` unless ``force``; one newer heals the
    pointer forward and loads.
    """
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = (json.loads(bytes(z["__meta__"]).decode())
                    if "__meta__" in z.files else {})
    except (zipfile.BadZipFile, zlib.error, EOFError) as e:
        raise ArtifactCorruptError(
            f"{path}: truncated or corrupt npz ({e}) — suspected torn "
            f"write; recover from the previous generation or re-run the "
            f"producing stage") from e
    except ValueError as e:
        # np.load raises a bare ValueError on non-zip magic / header damage
        raise ArtifactCorruptError(
            f"{path}: unreadable artifact ({e}) — suspected torn write or "
            f"foreign file") from e
    want = meta.get("sha256")
    if want is not None:
        got = _payload_sha256(arrays)
        if got != want:
            raise ArtifactCorruptError(
                f"{path}: payload sha256 mismatch (stored {want[:12]}…, "
                f"recomputed {got[:12]}…) — corrupt or tampered artifact")
    if fenced and not force:
        entry = read_pointer(path)
        gen = meta.get("generation")
        ptr_gen = entry.get("generation") if entry is not None else None
        if isinstance(gen, int) and isinstance(ptr_gen, int):
            if gen < ptr_gen:
                raise ArtifactStaleError(
                    f"{path}: generation {gen} is older than the "
                    f"latest.json pointer ({ptr_gen}) — stale state "
                    f"(restored backup / superseded writer); pass force "
                    f"to load anyway")
            if gen > ptr_gen:
                # crash between rename and pointer swap: heal forward
                _swap_pointer(path, gen, _file_sha256(path))
    return arrays, meta


def _numpy(x) -> np.ndarray:
    """A tensor as numpy; bfloat16, which numpy lacks (and which npz could
    not hold anyway), as its bit pattern in a uint16 array."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def save_risk_outputs(path: str, outputs, meta: dict | None = None):
    """Persist a ``RiskModelOutputs`` tuple."""
    save_artifact(path, {f: _numpy(getattr(outputs, f))
                         for f in outputs._fields}, meta)


def load_risk_outputs(path: str, device=None):
    """Rehydrate a :func:`save_risk_outputs` artifact as
    ``(RiskModelOutputs, meta)``, tensors on ``device`` (None: the card)."""
    from mfm_tpu_torch.models.risk_model import RiskModelOutputs

    dev = resolve_device(device)
    arrays, meta = load_artifact(path)
    missing = set(RiskModelOutputs._fields) - set(arrays)
    if missing:
        raise ValueError(f"{path}: not a risk-outputs artifact — missing "
                         f"field(s) {sorted(missing)}")
    return RiskModelOutputs(**{f: torch.from_numpy(arrays[f]).to(dev)
                               for f in RiskModelOutputs._fields}), meta


# -- risk-model state (the daily-update checkpoint) ---------------------------

_NW_SCALARS = ("nw_t", "nw_S", "nw_A", "nw_Z")
_NW_STACKED = ("nw_Ps", "nw_hs", "nw_gs", "nw_Slags", "nw_xlags")


def state_arrays(state) -> tuple[dict, dict]:
    """A ``RiskModelState`` as the checkpoint's ``(arrays, meta)``: numpy
    arrays under the reference's npz keys, and the JSON-able meta."""
    t, S, A, Z, Ps, hs, gs, Slags, xlags = (
        tuple(_numpy(x) for x in leaf) if isinstance(leaf, tuple)
        else _numpy(leaf) for leaf in state.nw_carry)

    def stack(xs, like):
        return (np.stack(xs) if xs
                else np.zeros((0,) + like.shape, like.dtype))

    arrays = {
        "nw_t": t, "nw_S": S, "nw_A": A, "nw_Z": Z,
        "nw_Ps": stack(Ps, A), "nw_hs": stack(hs, S), "nw_gs": stack(gs, Z),
        "nw_Slags": stack(Slags, S), "nw_xlags": stack(xlags, S),
        "vr_num": _numpy(state.vr_num), "vr_den": _numpy(state.vr_den),
    }
    # exactly one eigen representation: the frozen simulated covariances
    # or the incremental mode's draw tensor + raw prefix moments
    if state.sim_covs is not None:
        arrays["sim_covs"] = _numpy(state.sim_covs)
    eig_draws_dtype = None
    if state.eig_draws is not None:
        for k in ("eig_draws", "eig_R", "eig_p", "eig_n"):
            arrays[k] = _numpy(getattr(state, k))
        if state.eig_draws.dtype == torch.bfloat16:
            # the bit pattern is stored; the meta names the real dtype
            eig_draws_dtype = "bfloat16"
    if state.guarded:
        for k in ("last_good_cov", "staleness", "quarantine_count",
                  "guard_ring", "guard_ring_pos"):
            key = k if k.startswith("guard_") else "guard_" + k
            arrays[key] = _numpy(getattr(state, k))
    meta = {
        "kind": "risk_state",
        "nw_q": len(Ps),
        "sim_length": state.sim_length,
        "eigen_batch_hint": state.eigen_batch_hint,
        "stamp": _stamp_to_json(state.stamp),
        "last_date": state.last_date,
    }
    if eig_draws_dtype is not None:
        meta["eig_draws_dtype"] = eig_draws_dtype
    return arrays, meta


def save_risk_state(path: str, state, meta: dict | None = None):
    """Persist a ``RiskModelState`` as a fenced checkpoint.  npz round-trips
    every dtype bit-exactly, so a rehydrated state resumes bitwise."""
    arrays, state_meta = state_arrays(state)
    save_artifact(path, arrays, {**state_meta, **(meta or {})}, fenced=True)


def load_risk_state(path: str, device=None, *, force: bool = False):
    """Rehydrate a :func:`save_risk_state` artifact, from either package.

    Returns ``(RiskModelState, meta)`` with every tensor on ``device``
    (None: the CUDA card; raises without one) in its exact saved dtype, so
    an update from the loaded state is bitwise the in-process
    continuation.  Loads are fenced: a generation older than the
    directory's ``latest.json`` raises :class:`ArtifactStaleError` unless
    ``force``.
    """
    from mfm_tpu_torch.models.risk_model import RiskModelState

    dev = resolve_device(device)
    arrays, meta = load_artifact(path, fenced=True, force=force)
    missing = (set(_NW_SCALARS) | set(_NW_STACKED)
               | {"vr_num", "vr_den"}) - set(arrays)
    incremental = "eig_draws" in arrays
    if incremental:
        missing |= {"eig_R", "eig_p", "eig_n"} - set(arrays)
    elif "sim_covs" not in arrays:
        missing.add("sim_covs")
    if meta.get("kind") != "risk_state" or missing:
        raise ValueError(f"{path}: not a risk-state artifact"
                         + (f" — missing field(s) {sorted(missing)}"
                            if missing else ""))
    draws_dtype = meta.get("eig_draws_dtype")
    if draws_dtype not in (None, "bfloat16"):
        raise ValueError(f"{path}: unknown eig_draws_dtype {draws_dtype!r}")
    own = lambda name: torch.from_numpy(arrays[name].copy()).to(dev)
    unstack = lambda name: own(name).unbind(0)
    nw_carry = (
        own("nw_t"), own("nw_S"), own("nw_A"), own("nw_Z"),
        unstack("nw_Ps"), unstack("nw_hs"), unstack("nw_gs"),
        unstack("nw_Slags"), unstack("nw_xlags"),
    )
    guard = {}
    if "guard_last_good_cov" in arrays:
        guard = dict(
            last_good_cov=own("guard_last_good_cov"),
            staleness=own("guard_staleness"),
            quarantine_count=own("guard_quarantine_count"),
            guard_ring=own("guard_ring"),
            guard_ring_pos=own("guard_ring_pos"),
        )
    eig = {}
    if incremental:
        eig = {k: own(k) for k in ("eig_R", "eig_p", "eig_n")}
        draws = arrays["eig_draws"]
        eig["eig_draws"] = (
            own("eig_draws") if draws_dtype is None else
            # the saved uint16 bit pattern, reinterpreted
            torch.from_numpy(draws.view(np.int16).copy()).view(
                torch.bfloat16).to(dev))
    state = RiskModelState(
        nw_carry, own("vr_num"), own("vr_den"),
        own("sim_covs") if "sim_covs" in arrays else None,
        sim_length=meta["sim_length"],
        eigen_batch_hint=int(meta["eigen_batch_hint"]),
        stamp=_stamp_from_json(meta["stamp"]),
        last_date=meta.get("last_date"),
        **guard, **eig,
    )
    return state, meta


def _stamp_to_json(obj):
    """Nested tuples -> nested lists with a tag, reversibly (the stamp is
    compared with ``==`` against a live model's tuple stamp)."""
    if isinstance(obj, tuple):
        return {"__tuple__": [_stamp_to_json(x) for x in obj]}
    return obj


def _stamp_from_json(obj):
    if isinstance(obj, dict) and "__tuple__" in obj:
        return tuple(_stamp_from_json(x) for x in obj["__tuple__"])
    return obj
