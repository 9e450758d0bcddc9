"""The port's fault injection (``mfm_tpu_torch/utils/chaos.py``) and the
fenced checkpoint's crash points and counters
(``mfm_tpu_torch/data/artifacts.py``), held against the JAX package:

- the byte faults damage the same bytes as the reference's for a seed;
- the data faults give the same arrays (numpy, and tensors the same);
- ``plan_suite`` is the reference's, plan for plan, for several seeds;
- a checkpoint written by either package, truncated or corrupted, is
  refused by both packages' loaders;
- the SIGKILL drills at ``save_artifact.after_tmp`` / ``.after_rename``
  (the counterparts of ``tests/test_chaos.py``'s);
- the ``mfm_checkpoint_*`` metrics move as the reference's over one
  sequence of save, load, corrupt, stale and heal-forward.

Everything is exact: bytes, arrays and counts are compared for equality.
"""

import dataclasses
import os
import shutil
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data import artifacts as ref_art
from mfm_tpu.models.risk_model import RiskModel as RefRiskModel
from mfm_tpu.obs import instrument as ref_inst
from mfm_tpu.utils import chaos as ref_chaos
from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch.data import artifacts as art
from mfm_tpu_torch.obs import instrument as inst
from mfm_tpu_torch.utils import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N, P, Q, M = 40, 16, 3, 2, 4


# -- byte faults ------------------------------------------------------------------

def _twin_files(tmp_path, size=4096, seed=0):
    data = np.random.default_rng(seed).bytes(size)
    paths = []
    for name in ("port.bin", "ref.bin"):
        p = tmp_path / name
        p.write_bytes(data)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("n_bytes", [0, 64, 1000, 10_000])
def test_truncate_file_cuts_the_same_bytes(tmp_path, n_bytes):
    port, ref = _twin_files(tmp_path)
    assert chaos.truncate_file(port, n_bytes) == \
        ref_chaos.truncate_file(ref, n_bytes)
    assert open(port, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("n_bytes", [1, 8, 64])
def test_corrupt_file_flips_the_same_bits(tmp_path, seed, n_bytes):
    port, ref = _twin_files(tmp_path, seed=seed)
    before = open(port, "rb").read()
    offsets = chaos.corrupt_file(port, n_bytes, seed)
    assert offsets == ref_chaos.corrupt_file(ref, n_bytes, seed)
    after = open(port, "rb").read()
    assert after == open(ref, "rb").read()
    changed = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
    assert changed == offsets


# -- data faults ------------------------------------------------------------------

def _panel(seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.02, (12, 50)), rng.random((12, 50)) > 0.1


@pytest.mark.parametrize("frac", [0.05, 0.5, 1.0])
def test_poison_nan_matches_the_reference(frac):
    ret, _ = _panel()
    want = ref_chaos.poison_nan(ret.copy(), [2, 7], frac=frac, seed=4)
    got = chaos.poison_nan(ret.copy(), [2, 7], frac=frac, seed=4)
    np.testing.assert_array_equal(got, want)
    t = chaos.poison_nan(torch.from_numpy(ret.copy()), [2, 7], frac=frac,
                         seed=4)
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("magnitude,frac", [(5.0, 0.3), (0.5, 1.0)])
def test_poison_outliers_matches_the_reference(magnitude, frac):
    ret, _ = _panel()
    want = ref_chaos.poison_outliers(ret.copy(), [0, 11], magnitude, frac,
                                     seed=9)
    got = chaos.poison_outliers(ret.copy(), [0, 11], magnitude, frac, seed=9)
    np.testing.assert_array_equal(got, want)
    t = chaos.poison_outliers(torch.from_numpy(ret.copy()), [0, 11],
                              magnitude, frac, seed=9)
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("keep_frac", [0.2, 0.75])
def test_poison_universe_matches_the_reference(keep_frac):
    _, valid = _panel()
    want = ref_chaos.poison_universe(valid.copy(), [3, 5], keep_frac, seed=2)
    got = chaos.poison_universe(valid.copy(), [3, 5], keep_frac, seed=2)
    np.testing.assert_array_equal(got, want)
    t = chaos.poison_universe(torch.from_numpy(valid.copy()), [3, 5],
                              keep_frac, seed=2)
    np.testing.assert_array_equal(t.numpy(), want)


# -- fault plans ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 1000])
def test_plan_suite_is_the_references(seed):
    got = [dataclasses.astuple(p) for p in chaos.plan_suite(seed)]
    want = [dataclasses.astuple(p) for p in ref_chaos.plan_suite(seed)]
    assert got == want and len(got) == 29
    plan = chaos.plan_suite(seed)[6]
    assert plan.param("magnitude") == 5.0 and plan.param("x", 3) == 3


def test_crash_points_cover_the_write_protocol():
    assert chaos.CRASH_POINTS[:2] == ("save_artifact.after_tmp",
                                      "save_artifact.after_rename")
    assert set(chaos.CRASH_POINTS) == set(ref_chaos.CRASH_POINTS)


# -- damaged checkpoints, either package's, refused by both -----------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A fenced risk-state checkpoint written by each package."""
    rng = np.random.default_rng(5)
    panels = (rng.normal(0, 0.02, (T, N)), rng.lognormal(10, 1, (T, N)),
              rng.normal(size=(T, N, Q)),
              rng.integers(0, P, (T, N)).astype(np.int32),
              rng.random((T, N)) > 0.05)
    root = tmp_path_factory.mktemp("ckpts")
    port = root / "port" / "state.npz"
    _, st = RiskModel(*panels, n_industries=P, device="cpu",
                      config=RiskModelConfig(eigen_n_sims=M)).init_state()
    art.save_risk_state(str(port), st)
    ref = root / "ref" / "state.npz"
    _, rst = RefRiskModel(*(jnp.asarray(p) for p in panels), n_industries=P,
                          config=RefConfig(eigen_n_sims=M,
                                           seed=5)).init_state()
    ref_art.save_risk_state(str(ref), rst)
    return {"port": port, "ref": ref}


@pytest.mark.parametrize("fault", ["truncate-tail-64", "truncate-half",
                                   "corrupt-8-bytes"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_damaged_checkpoint_refused_by_both_loaders(checkpoints, tmp_path,
                                                    writer, fault):
    d = tmp_path / writer
    shutil.copytree(checkpoints[writer].parent, d)
    path = str(d / "state.npz")
    # both loaders take the undamaged file
    art.load_risk_state(path, "cpu")
    ref_art.load_risk_state(path)
    plan = next(p for p in chaos.plan_suite(0) if p.name == fault)
    if plan.kind == "truncate":
        n = (int(plan.param("frac") * os.path.getsize(path))
             if plan.param("frac") is not None else plan.param("n_bytes"))
        chaos.truncate_file(path, n)
    else:
        chaos.corrupt_file(path, plan.param("n_bytes"), plan.seed)
    with pytest.raises(art.ArtifactCorruptError):
        art.load_risk_state(path, "cpu")
    with pytest.raises(ref_art.ArtifactCorruptError):
        ref_art.load_risk_state(path)


# -- real crash drills (subprocess SIGKILL) ----------------------------------------

_SAVE_SCRIPT = """\
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from mfm_tpu_torch.data.artifacts import save_artifact
save_artifact({path!r}, {{"x": np.arange(12.0) + {stamp}}},
              {{"kind": "test", "note": {stamp}}}, fenced=True)
"""


def _save_in_subprocess(path, stamp, kill_at=None):
    env = dict(os.environ)
    env.pop("MFM_CHAOS_KILL", None)
    env.pop("MFM_CHAOS_KILL_MATCH", None)
    if kill_at:
        env["MFM_CHAOS_KILL"] = kill_at
    return subprocess.run(
        [sys.executable, "-c",
         _SAVE_SCRIPT.format(repo=REPO, path=path, stamp=stamp)],
        env=env, capture_output=True, text=True, timeout=120)


def test_sigkill_after_tmp_preserves_old_checkpoint(tmp_path):
    p = str(tmp_path / "state.npz")
    assert _save_in_subprocess(p, 1).returncode == 0
    proc = _save_in_subprocess(p, 2, kill_at="save_artifact.after_tmp")
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert os.path.exists(p + ".tmp.npz")   # the torn write's tmp stays
    arrays, meta = art.load_artifact(p, fenced=True)
    assert meta["note"] == 1 and meta["generation"] == 1
    np.testing.assert_array_equal(arrays["x"], np.arange(12.0) + 1)
    # the reference's loader reads the port's fenced pair the same way
    _, rmeta = ref_art.load_artifact(p, fenced=True)
    assert rmeta["generation"] == 1
    # the retried write wins cleanly over the torn tmp
    assert _save_in_subprocess(p, 2).returncode == 0
    _, meta = art.load_artifact(p, fenced=True)
    assert meta["note"] == 2 and meta["generation"] == 2


def test_sigkill_after_rename_heals_pointer(tmp_path):
    p = str(tmp_path / "state.npz")
    assert _save_in_subprocess(p, 1).returncode == 0
    proc = _save_in_subprocess(p, 2, kill_at="save_artifact.after_rename")
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    # new file live, pointer still at generation 1 — load accepts and heals
    assert art.read_pointer(p)["generation"] == 1
    arrays, meta = art.load_artifact(p, fenced=True)
    assert meta["note"] == 2 and meta["generation"] == 2
    assert art.read_pointer(p)["generation"] == 2


def test_kill_match_narrows_to_a_path(tmp_path, monkeypatch):
    p = str(tmp_path / "state.npz")
    monkeypatch.setenv("MFM_CHAOS_KILL", "save_artifact.after_tmp")
    monkeypatch.setenv("MFM_CHAOS_KILL_MATCH", "other_dir")
    # the match gate holds: this save is not the one to kill
    art.save_artifact(p, {"x": np.zeros(3)}, fenced=True)
    assert art.load_artifact(p, fenced=True)[1]["generation"] == 1


# -- the checkpoint counters -----------------------------------------------------

_COUNTERS = ("CHECKPOINT_SAVES_TOTAL", "CHECKPOINT_LOADS_TOTAL",
             "CHECKPOINT_CORRUPT_TOTAL", "CHECKPOINT_STALE_TOTAL",
             "CHECKPOINT_HEAL_FORWARD_TOTAL")
_HISTOGRAMS = ("CHECKPOINT_SAVE_SECONDS", "CHECKPOINT_LOAD_SECONDS")


def _readings(mod) -> dict:
    out = {k: getattr(mod, k).value() for k in _COUNTERS}
    out.update({k: getattr(mod, k).cumulative()[-1][1] for k in _HISTOGRAMS})
    out["CHECKPOINT_GENERATION"] = mod.CHECKPOINT_GENERATION.value()
    return out


def _sequence(a, d):
    """save, load, heal-forward, stale, corrupt — each event once or more."""
    p = os.path.join(d, "state.npz")
    snap = os.path.join(d, "snap")
    os.makedirs(snap)
    a.save_artifact(p, {"x": np.arange(4.0)}, {"kind": "t"}, fenced=True)
    a.load_artifact(p, fenced=True)
    shutil.copy(p, os.path.join(snap, "state.npz"))
    shutil.copy(os.path.join(d, "latest.json"), snap)
    a.save_artifact(p, {"x": np.arange(5.0)}, {"kind": "t"}, fenced=True)
    # the writer "died" between the rename and the pointer swap: generation
    # 2's file under generation 1's pointer heals forward
    shutil.copy(os.path.join(snap, "latest.json"), d)
    a.load_artifact(p, fenced=True)
    # a restored backup (generation 1) under pointer 2 is stale
    shutil.copy(os.path.join(snap, "state.npz"), p)
    with pytest.raises(a.ArtifactStaleError):
        a.load_artifact(p, fenced=True)
    a.load_artifact(p, fenced=True, force=True)
    a.save_artifact(os.path.join(d, "raw.npz"), {"y": np.ones(2)})
    chaos.truncate_file(p, 64)
    with pytest.raises(a.ArtifactCorruptError):
        a.load_artifact(p, fenced=True)


def test_checkpoint_counters_move_as_the_references(tmp_path):
    deltas = {}
    for name, a, mod in (("port", art, inst), ("ref", ref_art, ref_inst)):
        before = _readings(mod)
        d = tmp_path / name
        d.mkdir()
        _sequence(a, str(d))
        after = _readings(mod)
        deltas[name] = {k: after[k] - before[k] for k in after
                        if k != "CHECKPOINT_GENERATION"}
        deltas[name]["generation"] = after["CHECKPOINT_GENERATION"]
    assert deltas["port"] == deltas["ref"]
    assert deltas["port"] == {
        "CHECKPOINT_SAVES_TOTAL": 3, "CHECKPOINT_LOADS_TOTAL": 3,
        "CHECKPOINT_CORRUPT_TOTAL": 1, "CHECKPOINT_STALE_TOTAL": 1,
        "CHECKPOINT_HEAL_FORWARD_TOTAL": 1, "CHECKPOINT_SAVE_SECONDS": 3,
        "CHECKPOINT_LOAD_SECONDS": 3, "generation": 1}


def test_checkpoint_metric_catalog_is_the_references():
    from mfm_tpu.obs.metrics import REGISTRY as REF
    from mfm_tpu_torch.obs.metrics import REGISTRY

    def catalog(reg):
        return {m.name: (type(m).__name__, m.labelnames)
                for m in reg.metrics() if m.name.startswith("mfm_checkpoint")}

    assert catalog(REGISTRY) == catalog(REF) and len(catalog(REGISTRY)) == 8
