"""The port's serve CLI (``python -m mfm_tpu_torch.cli``) on the CPU at
float64, against the JAX package's CLI.

One synthetic barra table (``synthetic_barra_table(T=40, N=48, P=4, Q=2,
seed=7)``) runs through both packages' risk pipelines with the same
injected ``sim_covs``, each saving its own guarded checkpoint.  Then:

- ``serve --device cpu --gulp`` on the port's checkpoint answers the
  reference's ``serve --gulp`` on its own: the same ids and outcomes in the
  same order, numbers within the pipeline tests' budget (rtol 1e-8) — but
  for a construct answer's weights and ``diag``.  This checkpoint's
  min-vol optimum is flat: 2,000 projected-gradient steps stop at a KKT
  residual near 1e-5, and the iterate's roundoff moves along the flat
  directions, so the two packages' weights differ by up to 5.7e-9 and
  their residuals by up to 3.7% even on the same checkpoint, while the
  vols agree to 1e-13.  Construct weights are held to 1e-7 absolute, the
  residual to 10%, the vol to rtol 1e-8;
- a pipe fleet (``--replicas 2``) with one replica SIGKILLed by the
  ``serve.after_batch`` crash point answers every line bitwise the port's
  own ``--gulp`` replay, its merged manifest counts the loss with a
  consistent delivery audit, and ``doctor --serve`` exits as the
  reference's does on the same directory;
- the socket/HTTP front end answers, shows its SLO block and workers, and
  writes its fleet manifest on SIGTERM;
- ``--device cuda`` raises without a card; the reference's subcommands
  and flags the port does not carry yet exit non-zero naming their
  ROADMAP.md item; every spawn names ``mfm_tpu_torch.cli``.

Every subprocess wait and socket read carries a timeout.
"""

import ast
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu import cli as ref_cli
from mfm_tpu import pipeline as ref_pipeline
from mfm_tpu.config import PipelineConfig as RefPipelineConfig
from mfm_tpu.config import QuarantinePolicy as RefPolicy
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu_torch import cli
from mfm_tpu_torch.convert import pipeline_config_from_reference
from mfm_tpu_torch.data.synthetic import synthetic_barra_table
from mfm_tpu_torch.pipeline import run_risk_pipeline, save_pipeline_state
from mfm_tpu_torch.serve.replica import worker_cmd

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import trafficgen  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
T, N, P, Q, M = 40, 48, 4, 2, 16
K = 1 + P + Q
RTOL = 1e-8
#: config 12's request mix: plain, benchmark, scenario, construct, sweep
MIX = (0.55, 0.25, 0.0, 0.20, 0.0)
SERVE_FLAGS = ["--batch-max", "8", "--deadline-s", "600"]
TIMEOUT = 120


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(port dir, reference dir), each holding its package's guarded
    checkpoint of the same table, the benchmarks file and a request
    stream with a few malformed lines."""
    root = tmp_path_factory.mktemp("serve_cli")
    table, _ = synthetic_barra_table(T=T, N=N, P=P, Q=Q, seed=7)
    d = np.random.default_rng(1).standard_normal((M, K, T))
    d -= d.mean(axis=-1, keepdims=True)
    sim = np.einsum("mkt,mlt->mkl", d, d) / (T - 1)
    ref_cfg = RefPipelineConfig(
        risk=RefConfig(eigen_n_sims=M, quarantine=RefPolicy(enabled=True)),
        dtype="float64")
    port_dir, ref_dir = root / "port", root / "ref"
    port = run_risk_pipeline(
        table, config=pipeline_config_from_reference(
            __import__("dataclasses").asdict(ref_cfg)),
        with_state=True, device="cpu", sim_covs=torch.from_numpy(sim),
        sim_length=T)
    save_pipeline_state(str(port_dir / "state.npz"), port)
    old = os.environ.get("MFM_EIGH_CPU_JACOBI_BATCH")
    os.environ["MFM_EIGH_CPU_JACOBI_BATCH"] = "1"
    try:
        ref = ref_pipeline.run_risk_pipeline(
            pd.DataFrame(table), config=ref_cfg, with_state=True,
            sim_covs=jnp.asarray(sim), sim_length=T)
    finally:
        if old is None:
            os.environ.pop("MFM_EIGH_CPU_JACOBI_BATCH")
        else:
            os.environ["MFM_EIGH_CPU_JACOBI_BATCH"] = old
    ref_pipeline.save_pipeline_state(str(ref_dir / "state.npz"), ref)
    lines = trafficgen.gen_requests(7, 48, K, mix=MIX)
    lines[5:5] = ['{"id": "torn", "weights": [0.1,',
                  json.dumps({"id": "short", "weights": [0.1, 0.2]}),
                  json.dumps({"id": "nobench", "weights": [0.1] * K,
                              "benchmark": "nope"})]
    bench = np.round(0.1 * np.random.default_rng(3).standard_normal(K), 6)
    for dd in (port_dir, ref_dir):
        (dd / "req.jsonl").write_text("\n".join(lines) + "\n")
        (dd / "benchmarks.json").write_text(json.dumps(
            {"idx": bench.tolist()}))
    return port_dir, ref_dir


def _env(**extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           **extra}
    for k in ("MFM_CHAOS_KILL", "MFM_CHAOS_KILL_MATCH",
              "MFM_CHAOS_KILL_REPLICA"):
        if k not in extra:
            env.pop(k, None)
    return env


def _serve(pkg, d, out, *flags, env=None):
    cmd = [sys.executable, "-m", f"{pkg}.cli"]
    cmd += (["--platform", "cpu", "serve", "state.npz"] if pkg == "mfm_tpu"
            else ["serve", "state.npz", "--device", "cpu"])
    cmd += ["--input", "req.jsonl", "--output", out,
            "--benchmarks", "benchmarks.json", *SERVE_FLAGS, *flags]
    proc = subprocess.run(cmd, cwd=d, env=env or _env(), capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(ln) for ln in (Path(d) / out).read_text().splitlines()]


def _hold_construct(got, want, what):
    assert got["total_vol"] == pytest.approx(want["total_vol"], rel=RTOL)
    assert got["diag"] == pytest.approx(want["diag"], rel=0.1), what
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=0,
                               atol=1e-7, err_msg=what)
    got = {k: v for k, v in got.items()
           if k not in ("total_vol", "diag", "weights")}
    want = {k: v for k, v in want.items()
            if k not in ("total_vol", "diag", "weights")}
    _hold(got, want, what)


def _hold(got, want, what):
    if isinstance(want, float) and isinstance(got, float):
        assert got == pytest.approx(want, rel=RTOL, abs=1e-300), what
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        scale = max((abs(x) for x in want if isinstance(x, float)),
                    default=0.0)
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(w, float) and isinstance(g, float):
                assert g == pytest.approx(w, rel=RTOL, abs=1e-12 * scale), \
                    f"{what}[{i}]"
            else:
                _hold(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), what
        for k in want:
            _hold(got[k], want[k], f"{what}.{k}")
    else:
        assert got == want, what


def test_gulp_replay_is_the_reference_cli(ckpts):
    port_dir, ref_dir = ckpts
    got = _serve("mfm_tpu_torch", port_dir, "gulp_port.jsonl", "--gulp")
    want = _serve("mfm_tpu", ref_dir, "gulp_ref.jsonl", "--gulp")
    assert [r["id"] for r in got] == [r["id"] for r in want]
    assert [r["outcome"] for r in got] == [r["outcome"] for r in want]
    outcomes = {r["outcome"] for r in got}
    assert outcomes == {"ok", "dead_letter"}
    assert sum(r.get("kind") == "construct" for r in got) >= 5
    for g, w in zip(got, want):
        (_hold_construct if w.get("kind") == "construct" else _hold)(
            g, w, g["id"])
    man = json.loads((port_dir / "serve_manifest.json").read_text())
    assert man["backend"] == "cpu" and man["serve"]["slo"]["schema"] == 1
    assert man["kernels"]["launches"] == {
        k: 0 for k in man["kernels"]["launches"]}
    assert man["kernels"]["libraries_loaded"] == 0


def _doctor(mod, d, *flags, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        mod.main(["doctor", str(d), *flags])
    out = capsys.readouterr().out
    return exc.value.code, json.loads(out) if out.strip() else None


def test_pipe_fleet_kill_drill(ckpts, capsys):
    """Two pipe replicas; replica 1 is SIGKILLed after it computed its
    second batch, before the envelopes reach the pipe.  The survivor
    answers everything bitwise the single-process replay, the manifest
    counts the loss and the redispatch, and doctor agrees with the
    reference's doctor on the directory."""
    port_dir, _ = ckpts
    gulp = _serve("mfm_tpu_torch", port_dir, "drill_gulp.jsonl", "--gulp")
    state_bytes = (port_dir / "state.npz").read_bytes()
    fleet = _serve("mfm_tpu_torch", port_dir, "drill_fleet.jsonl",
                   "--replicas", "2", env=_env(
                       MFM_CHAOS_KILL="serve.after_batch",
                       MFM_CHAOS_KILL_MATCH="batch1",
                       MFM_CHAOS_KILL_REPLICA="1"))
    assert (port_dir / "state.npz").read_bytes() == state_bytes
    assert not (port_dir / "serve_manifest.r1.json").exists()
    want = {json.dumps(r, sort_keys=True) for r in gulp}
    assert len(fleet) == len(gulp)
    assert {json.dumps(r, sort_keys=True) for r in fleet} == want
    fm = json.loads((port_dir / "fleet_manifest.json").read_text())["fleet"]
    assert [r["replica"] for r in fm["replicas"] if r["lost"]] == [1]
    assert fm["audit"]["consistent"]
    assert fm["transport"]["redispatches"] >= 1
    assert fm["replicas"][0]["worker_summary"]["requests_total"] >= 1
    codes = {}
    for name, mod in (("port", cli), ("reference", ref_cli)):
        codes[name] = _doctor(mod, port_dir, "--serve", capsys=capsys)
    assert codes["port"][0] == codes["reference"][0] == 0
    kinds = [r["kind"] for r in codes["port"][1]["records"]]
    assert kinds == [r.get("kind") for r in codes["reference"][1]["records"]]
    # a torn fleet manifest fails both doctors alike
    fpath = port_dir / "fleet_manifest.json"
    text = fpath.read_text()
    try:
        fpath.write_text(text[: len(text) // 2])
        torn = []
        for mod in (cli, ref_cli):
            code, rep = _doctor(mod, port_dir, "--serve", capsys=capsys)
            assert code == 1
            torn.append([(r["kind"], r["status"]) for r in rep["records"]])
        assert torn[0] == torn[1]
        assert ("fleet_manifest", "corrupt") in torn[0]
    finally:
        fpath.write_text(text)


def _http(addr, raw: bytes) -> tuple:
    with socket.create_connection(addr, timeout=30) as s:
        s.settimeout(30)
        s.sendall(raw)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    return head, body


def test_http_listener_fleet_and_sigterm(ckpts, capsys):
    port_dir, _ = ckpts
    gulp = {r["id"]: json.dumps(r, sort_keys=True) for r in _serve(
        "mfm_tpu_torch", port_dir, "http_gulp.jsonl", "--gulp")}
    for stale in port_dir.glob("fleet_manifest.json"):
        stale.unlink()
    err_path = port_dir / "listener.err"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mfm_tpu_torch.cli", "serve", "state.npz",
             "--device", "cpu", "--benchmarks", "benchmarks.json",
             *SERVE_FLAGS, "--listen", "127.0.0.1:0", "--http",
             "--replicas", "2", "--linger-s", "0.02"],
            cwd=port_dir, env=_env(), stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        addr = None
        t_end = time.monotonic() + TIMEOUT
        while addr is None and time.monotonic() < t_end \
                and proc.poll() is None:
            for ln in err_path.read_text().splitlines():
                if '"listening"' in ln:
                    host, _, port = json.loads(ln)["listening"].rpartition(
                        ":")
                    addr = (host, int(port))
            time.sleep(0.05)
        assert addr is not None, err_path.read_text()[-3000:]
        lines = (port_dir / "req.jsonl").read_text().splitlines()[:16]
        body = ("\n".join(lines) + "\n").encode()
        head, payload = _http(addr, b"POST / HTTP/1.1\r\nHost: x\r\n"
                              + f"Content-Length: {len(body)}\r\n".encode()
                              + b"Connection: close\r\n\r\n" + body)
        assert head.startswith(b"HTTP/1.1 200")
        resps = [json.loads(x) for x in payload.decode().splitlines()]
        # immediate answers (dead letters) come back before the batch's
        assert len(resps) == len(lines)
        for r in resps:
            assert json.dumps(r, sort_keys=True) == gulp[r["id"]]
        head, payload = _http(addr, b"GET /healthz HTTP/1.1\r\nHost: x\r\n"
                              b"Connection: close\r\n\r\n")
        hz = json.loads(payload)
        assert hz["slo"]["schema"] == 1 and len(hz["workers"]) == 2
        head, payload = _http(addr, b"GET /metrics HTTP/1.1\r\nHost: x\r\n"
                              b"Connection: close\r\n\r\n")
        snap = json.loads(payload)
        assert sorted(w["replica"] for w in snap["workers"]) == [0, 1]
        assert all(w["metrics"] for w in snap["workers"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert (port_dir / "fleet_manifest.json").exists()
    assert (port_dir / "flightrec.json").exists()   # the sigterm dump
    code, rep = _doctor(cli, port_dir, "--serve", capsys=capsys)
    assert code == 0, rep
    trig = [r["trigger"] for r in rep["records"] if r["kind"] == "flightrec"]
    assert "sigterm" in trig


def test_device_cuda_raises_without_a_card(ckpts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda serves on it")
    port_dir, _ = ckpts
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", str(port_dir / "state.npz"),
                  "--input", str(port_dir / "req.jsonl"),
                  "--output", str(port_dir / "never.jsonl")])
    assert not (port_dir / "never.jsonl").exists()


@pytest.mark.parametrize("argv,item", [
    (["risk", "--barra", "x.csv", "--mesh", "2x1"], "§A 16d"),
    (["pipeline", "--store", "s", "--mesh", "2x1"], "§A 16d"),
    (["audit", "--device", "cpu", "--passes", "A4"], "§A 22"),
    (["doctor", "--audit"], "§A 22"),
])
def test_mesh_and_audit_commands_are_ported(argv, item, monkeypatch,
                                           tmp_path):
    """Every subcommand of the reference is ported.  ``--mesh`` (§A 16d):
    ``risk`` refuses a mesh of more devices than are up, naming the
    virtual-device variable, and ``pipeline`` (which reads the flag at its
    append step) fails on its missing store exactly as without the flag.
    ``audit`` and ``doctor --audit`` (§A 22): the recompile-surface pass
    on the CPU and the committed snapshot's verification exit 0, from any
    working directory."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV

    monkeypatch.chdir(tmp_path)
    # absent for the test and after it (``audit`` sets it when unset)
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "1")
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV)
    if item == "§A 16d":
        def outcome(args):
            try:
                cli.main([*args, "--device", "cpu"])
            except (SystemExit, ValueError, OSError) as e:
                return type(e), str(e.code if isinstance(e, SystemExit)
                                    else e)
            return None

        got = outcome(argv)
        assert got is not None and "not ported" not in got[1]
        if argv[0] == "risk":
            assert got[0] is SystemExit and VIRTUAL_DEVICES_ENV in got[1]
            assert "needs 2 devices but only 1 are up" in got[1]
        else:
            assert got == outcome(argv[:-2])
        return
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 0


def test_spawns_name_the_port_cli():
    """``worker_cmd`` and every spawn in the port name ``mfm_tpu_torch.cli``
    (never the reference's ``mfm_tpu.cli``), and pass the device on."""
    cmd = worker_cmd("ck/state.npz", worker_id=3, policy_args=["--x"],
                     device="cpu")
    assert cmd[1:3] == ["-m", "mfm_tpu_torch.cli"]
    assert cmd[3:] == ["serve", "ck/state.npz", "--worker", "--worker-id",
                       "3", "--device", "cpu", "--x"]
    assert worker_cmd("s", worker_id=0)[-2:] == ["--device", "cuda"]
    for path in sorted((ROOT / "mfm_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "mfm_tpu.cli" not in node.value, path
    src = (ROOT / "mfm_tpu_torch" / "cli.py").read_text()
    assert "worker_cmd(state_path" in src and "device=args.device" in src


def test_import_builds_and_loads_no_kernel():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import mfm_tpu_torch.cli, mfm_tpu_torch.serve.replica\n"
            "from mfm_tpu_torch.ops import _build\n"
            "print(_build.load.cache_info().currsize,\n"
            "      'jax' in sys.modules, 'mfm_tpu' in sys.modules)"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "False", "False"]


def test_metrics_dir_and_the_metrics_subcommand(ckpts, capsys):
    """``--metrics-dir`` leaves the event stream, a Prometheus textfile
    that parses, the snapshot and the Chrome trace; ``metrics dump`` and
    ``snapshot`` read them back."""
    from mfm_tpu_torch.obs.trace import parse_chrome_trace

    port_dir, _ = ckpts
    mdir = port_dir / "metrics"
    _serve("mfm_tpu_torch", port_dir, "metrics_gulp.jsonl", "--gulp",
           "--metrics-dir", str(mdir))
    events = [json.loads(x) for x in
              (mdir / "events.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events] == ["run_start", "run_end"]
    assert list(events[0])[:3] == ["ts", "level", "event"]
    names = [e["name"] for e in parse_chrome_trace(
        (mdir / "trace.json").read_text())]
    assert "cli.serve" in names and "serve.request" in names
    capsys.readouterr()
    cli.main(["metrics", "dump", str(mdir)])
    assert "mfm_query_requests_total" in capsys.readouterr().out
    cli.main(["metrics", "snapshot", str(mdir)])
    snap = json.loads(capsys.readouterr().out)
    assert snap["schema"] == 1
    assert "mfm_query_requests_total" in snap["metrics"]


def test_prometheus_exposition_is_the_reference():
    """The same series in both packages' registries render to the same
    textfile, and each package's parser reads the other's."""
    from mfm_tpu.obs import exporters as ref_exporters
    from mfm_tpu.obs.metrics import MetricsRegistry as RefRegistry
    from mfm_tpu_torch.obs import exporters
    from mfm_tpu_torch.obs.metrics import MetricsRegistry

    texts = []
    for reg in (MetricsRegistry(), RefRegistry()):
        c = reg.counter("mfm_x_total", "a counter", labelnames=("outcome",))
        c.inc(3, outcome="ok")
        c.inc(1, outcome='we"ird\nlabel')
        reg.gauge("mfm_y", "a gauge").set_value(-2.5)
        h = reg.histogram("mfm_z_seconds", "a histogram",
                          buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        texts.append((exporters if isinstance(reg, MetricsRegistry)
                      else ref_exporters).render_prometheus(reg))
    assert texts[0] == texts[1]
    assert exporters.parse_prometheus(texts[1]) \
        == ref_exporters.parse_prometheus(texts[0])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_run_manifest_round_trips_between_the_packages(tmp_path, writer):
    """A manifest either package writes reads back in both; a torn file,
    another schema version or a missing health verdict is refused by
    both with ``ManifestError``."""
    from mfm_tpu.obs import manifest as ref_manifest
    from mfm_tpu_torch.obs import manifest

    w = manifest if writer == "port" else ref_manifest
    path = w.write_run_manifest(str(tmp_path), w.build_run_manifest(
        stamp_json={"__tuple__": [1, "x"]}, checkpoint="ck/state.npz",
        backend="cpu", extra={"serve": {"requests_total": 3}}))
    assert path == manifest.manifest_path_for(str(tmp_path / "state.npz"))
    got, want = (manifest.read_run_manifest(str(tmp_path)),
                 ref_manifest.read_run_manifest(str(tmp_path)))
    assert got == want and got["checkpoint"] == "state.npz"
    assert got["serve"] == {"requests_total": 3}
    good = Path(path).read_text()
    for bad in (good[: len(good) // 2],
                good.replace('"schema_version": 1', '"schema_version": 2'),
                json.dumps({"schema_version": 1})):
        Path(path).write_text(bad)
        for mod in (manifest, ref_manifest):
            with pytest.raises(mod.ManifestError):
                mod.read_run_manifest(path)
