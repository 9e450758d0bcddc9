"""The port's sharded runs (``mfm_tpu_torch/parallel/mesh.py``) on virtual
CPU meshes, case for case with ``tests/test_sharding.py``.

Every case holds the port's sharded run against its own unsharded run at
the same shapes BITWISE (equal bytes, NaN positions included), at float64
and float32, and, where the reference's case passes, against the
reference's sharded run on its 8 virtual CPU devices at float64 within
rtol 1e-8 (entries that cancel to near zero within 1e-12 of the field's
scale), with ``sim_covs`` injected as the parity doctrine says.  The
reference's two n999 cases fail on every run (ROADMAP.md §C), so those two
hold the port within itself only.  The port's meshes come from
``MFM_TORCH_VIRTUAL_DEVICES=8`` over the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as RefSharding
from jax.sharding import PartitionSpec as RefP

from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data.barra import barra_frame_to_arrays as ref_frame_to_arrays
from mfm_tpu.data.synthetic import synthetic_barra_table as ref_barra_table
from mfm_tpu.models.risk_model import RiskModel as RefRiskModel
from mfm_tpu.parallel import mesh as ref_mesh
from mfm_tpu_torch import RiskModel
from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
from mfm_tpu_torch.config import QuarantinePolicy, RiskModelConfig
from mfm_tpu_torch.convert import config_from_reference
from mfm_tpu_torch.data.synthetic import synthetic_risk_inputs
from mfm_tpu_torch.parallel.mesh import (
    P,
    NamedSharding,
    ShardedPanel,
    device_put,
    make_mesh,
    pad_to_mesh,
    replicated,
    shard_panel,
    use_mesh,
)

torch.set_num_threads(2)

PANEL = ("ret", "cap", "styles", "industry", "valid")
DTYPES = [torch.float64, torch.float32]
DT_IDS = ["f64", "f32"]


@pytest.fixture(autouse=True)
def _eight_virtual_devices(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bitwise(tag, a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, tag
    assert a.tobytes() == b.tobytes(), f"{tag} not bitwise"


def _close(tag, got, want, rtol=1e-8):
    """rtol, with near-zero entries held to 1e-12 of the field's scale;
    NaN positions agree."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, tag
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=tag)
        return
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale,
                               equal_nan=True, err_msg=tag)


def _port_panels(a, dtype):
    """The reference's BarraArrays (or a tuple of numpy panels) as the
    port's tensors: floats in ``dtype``, industry int32, valid bool."""
    arrs = [getattr(a, k) for k in PANEL] if hasattr(a, "ret") else list(a)
    out = []
    for k, x in zip(PANEL, arrs):
        x = np.asarray(x)
        t = torch.from_numpy(np.ascontiguousarray(x))
        if k == "industry":
            t = t.to(torch.int32)
        elif k == "valid":
            t = t.to(torch.bool)
        else:
            t = t.to(dtype)
        out.append(t)
    return tuple(out)


def _sim_covs(K, M=8, L=100, seed=0):
    d = np.random.default_rng(seed).standard_normal((M, K, L))
    d -= d.mean(axis=-1, keepdims=True)
    return np.einsum("mkt,mlt->mkl", d, d) / (L - 1)


@pytest.fixture(scope="module")
def arrays():
    df, style_names = ref_barra_table(T=64, N=48, P=5, Q=3, seed=9,
                                      missing=0.04)
    return ref_frame_to_arrays(df, style_names=style_names)


def _cfg(**kw):
    return RiskModelConfig(eigen_n_sims=8, eigen_sim_length=100, **kw)


def _ref_sharded(arrs, P_, sim_covs, n_date, n_stock, **cfg_kw):
    """The reference's sharded ``run`` on its 8 virtual CPU devices (its
    Jacobi eigh route), padded to the mesh, outputs as numpy."""
    cfg = RefConfig(eigen_n_sims=8, eigen_sim_length=100, **cfg_kw)
    mesh = ref_mesh.make_mesh(n_date, n_stock,
                              devices=jax.devices()[:n_date * n_stock])
    args = tuple(ref_mesh.pad_to_mesh(jnp.asarray(v), mesh) for v in arrs)
    sharded = ref_mesh.shard_panel(args, mesh)

    def pipeline(ret, cap, styles, industry, valid, sc):
        m = RefRiskModel(ret, cap, styles, industry, valid,
                         n_industries=P_, config=cfg)
        return m.run(sim_covs=sc)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")
        with ref_mesh.use_mesh(mesh):
            out = jax.jit(pipeline)(*sharded, jnp.asarray(sim_covs))
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _port_sharded_and_base(panels, P_, sim_covs, n_date, n_stock, cfg):
    """The port's run on the mesh-padded panels, sharded and unsharded."""
    mesh = make_mesh(n_date, n_stock, device="cpu")
    padded = tuple(pad_to_mesh(p, mesh) for p in panels)
    base = RiskModel(*padded, n_industries=P_, config=cfg,
                     device="cpu").run(sim_covs=sim_covs)
    with use_mesh(mesh):
        out = RiskModel(*shard_panel(padded, mesh), n_industries=P_,
                        config=cfg, device="cpu").run(sim_covs=sim_covs)
    return out, base, padded


def _assert_pipeline_case(a, n_date, n_stock, dtype):
    K = 1 + a.n_industries + a.styles.shape[-1]
    sc = _sim_covs(K)
    panels = _port_panels(a, dtype)
    out, base, padded = _port_sharded_and_base(
        panels, a.n_industries, torch.from_numpy(sc).to(dtype), n_date,
        n_stock, _cfg())
    T, N = a.ret.shape
    for name, s, b in zip(out._fields, out, base):
        _bitwise(f"run.{name}", s, b)
    # the padding is inert: cropped, the padded run is the unpadded one
    plain = RiskModel(*panels, n_industries=a.n_industries, config=_cfg(),
                      device="cpu").run(sim_covs=torch.from_numpy(sc).to(
                          dtype))
    for name, s, b in zip(out._fields, out, plain):
        s = s[:T, :N] if name == "specific_ret" else s[:T]
        _bitwise(f"cropped.{name}", s, b)
    if dtype == torch.float64:
        ref = _ref_sharded([getattr(a, k) for k in PANEL], a.n_industries,
                           sc, n_date, n_stock)
        for name in out._fields:
            _close(f"vs reference {name}", getattr(out, name), ref[name])


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_full_pipeline_sharded_matches_single_device(arrays, dtype):
    _assert_pipeline_case(arrays, 4, 2, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_full_pipeline_sharded_uneven_shapes(dtype):
    """T=67 on a 4-way date axis and N=45 on a 2-way stock axis: both
    padded (valid False), bitwise the unsharded run at the padded shapes
    and, cropped, the unpadded one."""
    df, style_names = ref_barra_table(T=67, N=45, P=5, Q=3, seed=11,
                                      missing=0.04)
    _assert_pipeline_case(ref_frame_to_arrays(df, style_names=style_names),
                          4, 2, dtype)


@pytest.mark.parametrize("nd,ns", [(2, 2), (4, 2), (8, 1), (1, 2)])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_run_fused_nine_fields_bitwise_on_each_mesh(nd, ns, dtype):
    """``run_fused`` at the smoke's meshes on an uneven panel (T=35,
    N=33): every mesh pads, every field bitwise."""
    P_, Q = 4, 3
    panels = _port_panels(synthetic_risk_inputs(35, 33, P_, Q, seed=2),
                          dtype)
    sc = torch.from_numpy(_sim_covs(1 + P_ + Q)).to(dtype)
    mesh = make_mesh(nd, ns, device="cpu")
    padded = tuple(pad_to_mesh(p, mesh) for p in panels)
    base = RiskModel(*padded, n_industries=P_, config=_cfg(),
                     device="cpu").run_fused(sim_covs=sc)
    with use_mesh(mesh):
        out = RiskModel(*shard_panel(padded, mesh), n_industries=P_,
                        config=_cfg(), device="cpu").run_fused(sim_covs=sc)
    assert len(out._fields) == 9
    for name, s, b in zip(out._fields, out, base):
        _bitwise(f"{nd}x{ns}.{name}", s, b)


def _engine_case(T, N, seed, dtype):
    """The 16-factor engine with its fields stock-sharded over all 8
    devices (rolling layout, NaN pads, the report id pads -1): bitwise
    the unsharded engine at the padded shape; cropped, within 1e-8 of the
    reference's stock-sharded engine at float64."""
    from mfm_tpu.config import FactorConfig as RefFactorConfig
    from mfm_tpu.data.synthetic import synthetic_market_panel
    from mfm_tpu.data.synthetic import panel_to_engine_fields as ref_fields
    from mfm_tpu.factors.engine import FactorEngine as RefEngine
    from mfm_tpu_torch.factors.engine import FactorEngine

    data = synthetic_market_panel(T=T, N=N, n_industries=5, seed=seed)
    fields = {k: np.asarray(v) for k, v in
              ref_fields(data, jnp.float64).items()}
    idx = torch.from_numpy(np.asarray(data["index_close"])).to(dtype)
    mesh = make_mesh(1, 8, device="cpu")

    def padded(k, v):
        v = pad_to_mesh(v, mesh, rolling=True,
                        fill=-1 if k == "end_date_code" else np.nan)
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t if k == "end_date_code" else t.to(dtype)

    pf = {k: padded(k, v) for k, v in fields.items()}
    base = FactorEngine(pf, idx, block=16, device="cpu").run()
    sh = device_put(pf, NamedSharding(mesh, P(None, "stock")))
    assert all(isinstance(v, ShardedPanel) for v in sh.values())
    with use_mesh(mesh):
        out = FactorEngine(sh, idx, block=16).run()
    assert set(out) == set(base)
    for k in base:
        _bitwise(f"engine.{k}", out[k], base[k])
    if dtype != torch.float64:
        return
    rmesh = ref_mesh.make_mesh(1, 8)
    rsh = {k: jax.device_put(
        ref_mesh.pad_to_mesh(jnp.asarray(v), rmesh, rolling=True,
                             fill=-1 if k == "end_date_code" else np.nan),
        RefSharding(rmesh, RefP(None, "stock"))) for k, v in fields.items()}
    eng = RefEngine(rsh, jnp.asarray(data["index_close"], jnp.float64),
                    config=RefFactorConfig(), block=16)
    with ref_mesh.use_mesh(rmesh):
        ref = {k: np.asarray(v)[:, :N] for k, v in eng.run().items()}
    for k in ref:
        _close(f"engine vs reference {k}", out[k][:, :N], ref[k])


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_factor_engine_uneven_stock_shards(dtype):
    _engine_case(T=70, N=30, seed=4, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_factor_engine_stock_sharded_matches_single_device(dtype):
    _engine_case(T=80, N=32, seed=3, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_full_pipeline_associative_nw_sharded_matches_scan(arrays, dtype):
    """``nw_method="associative"`` over a fully date-sharded 8x1 mesh:
    bitwise the unsharded associative run, within the reference's scan
    tolerances of the port's serial scan, and within 1e-8 of the
    reference's sharded associative run."""
    K = 1 + arrays.n_industries + arrays.styles.shape[-1]
    sc = _sim_covs(K)
    sct = torch.from_numpy(sc).to(dtype)
    panels = _port_panels(arrays, dtype)
    cfg = _cfg(nw_method="associative")
    out, base, _ = _port_sharded_and_base(panels, arrays.n_industries, sct,
                                          8, 1, cfg)
    for name, s, b in zip(out._fields, out, base):
        _bitwise(f"associative.{name}", s, b)
    scan = RiskModel(*panels, n_industries=arrays.n_industries,
                     config=_cfg(), device="cpu").run(sim_covs=sct)
    _bitwise("nw_valid", out.nw_valid, scan.nw_valid)
    if dtype == torch.float64:
        np.testing.assert_allclose(_np(out.nw_cov), _np(scan.nw_cov),
                                   rtol=1e-8, atol=1e-14)
        np.testing.assert_allclose(_np(out.lamb), _np(scan.lamb), rtol=1e-8,
                                   atol=1e-12)
        ref = _ref_sharded([getattr(arrays, k) for k in PANEL],
                           arrays.n_industries, sc, 8, 1,
                           nw_method="associative")
        for name in ("nw_cov", "nw_valid", "vr_cov", "lamb"):
            _close(f"vs reference {name}", getattr(out, name), ref[name])


def _fret(T, K, seed):
    rng = np.random.default_rng(seed)
    e = 0.01 * rng.standard_normal((T, K))
    f = np.copy(e)
    for t in range(1, T):
        f[t] += 0.4 * f[t - 1]
    return f


@pytest.mark.parametrize("T,K,q,hl", [(64, 9, 2, 20.0), (176, 10, 2, 252.0)],
                         ids=["sharding", "risk_stack"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_newey_west_associative_date_sharded(T, K, q, hl, dtype):
    """The associative Newey-West directly, its (T, K) input date-sharded
    over all 8 devices (``tests/test_sharding.py``'s case at (64, 9) and
    ``tests/test_risk_stack.py:202``'s at (176, 10)): it runs replicated,
    bitwise the unsharded call; within 1e-8 of the reference's sharded
    call at float64."""
    from mfm_tpu.models.newey_west import (
        newey_west_expanding_associative as ref_assoc,
    )
    from mfm_tpu_torch.models.newey_west import (
        newey_west_expanding_associative,
    )

    f = _fret(T, K, seed=4 if T == 64 else 7)
    ft = torch.from_numpy(f).to(dtype)
    base = newey_west_expanding_associative(ft, q=q, half_life=hl)
    mesh = make_mesh(8, 1, device="cpu")
    fs = device_put(ft, NamedSharding(mesh, P("date")))
    with use_mesh(mesh):
        got = newey_west_expanding_associative(fs, q=q, half_life=hl)
    _bitwise("covs", got[0], base[0])
    _bitwise("valid", got[1], base[1])
    if dtype == torch.float64:
        rmesh = ref_mesh.make_mesh(8, 1)
        rfs = jax.device_put(jnp.asarray(f), RefSharding(rmesh, RefP("date")))
        with ref_mesh.use_mesh(rmesh):
            rc, rv = jax.jit(lambda r: ref_assoc(r, q=q, half_life=hl))(rfs)
        _close("covs vs reference", got[0], np.asarray(rc))
        _bitwise("valid vs reference", got[1], np.asarray(rv))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_rolling_kernel_stock_sharded(dtype):
    """rolling_beta_hsigma with the stock axis over all 8 devices: each
    shard runs alone on its stocks, bitwise the unsharded kernel."""
    from mfm_tpu.ops.rolling import rolling_beta_hsigma as ref_rolling
    from mfm_tpu_torch.ops.rolling import rolling_beta_hsigma

    rng = np.random.default_rng(0)
    T, N = 80, 64
    ret = 0.01 * rng.standard_normal((T, N))
    ret[rng.random((T, N)) < 0.05] = np.nan
    mkt = 0.008 * rng.standard_normal(T)
    kw = dict(window=30, half_life=10, min_periods=8, block=32)
    rt, mt = (torch.from_numpy(x).to(dtype) for x in (ret, mkt))
    base = rolling_beta_hsigma(rt, mt, **kw)
    mesh = make_mesh(1, 8, device="cpu")
    rs = shard_panel(rt, mesh, rolling=True)
    ms = device_put(mt, replicated(mesh))
    got = rolling_beta_hsigma(rs, ms, **kw)
    _bitwise("beta", got[0], base[0])
    _bitwise("hsigma", got[1], base[1])
    if dtype == torch.float64:
        rmesh = ref_mesh.make_mesh(1, 8)
        rr = jax.device_put(jnp.asarray(ret),
                            ref_mesh.panel_sharding(rmesh, rolling=True))
        rm = jax.device_put(jnp.asarray(mkt), RefSharding(rmesh, RefP()))
        b, h = jax.jit(lambda r, m: ref_rolling(r, m, **kw))(rr, rm)
        _close("beta vs reference", got[0], np.asarray(b))
        _close("hsigma vs reference", got[1], np.asarray(h))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_regression_date_and_stock_sharded_2d(arrays, dtype):
    """The 2-D layout (dates over 'date', stocks over 'stock'): the stock
    axis is gathered once at entry, each date shard regresses alone."""
    panels = _port_panels(arrays, dtype)
    base = RiskModel(*panels, n_industries=arrays.n_industries,
                     config=_cfg(), device="cpu").reg_by_time()
    mesh = make_mesh(2, 4, device="cpu")
    with use_mesh(mesh):
        got = RiskModel(*shard_panel(panels, mesh),
                        n_industries=arrays.n_industries, config=_cfg(),
                        device="cpu").reg_by_time()
    for name, g, b in zip(("factor_ret", "specific_ret", "r2"), got, base):
        _bitwise(name, g, b)
    if dtype == torch.float64:
        rmesh = ref_mesh.make_mesh(2, 4)
        args = ref_mesh.shard_panel(
            tuple(jnp.asarray(getattr(arrays, k)) for k in PANEL), rmesh)
        cfg = RefConfig(eigen_n_sims=8, eigen_sim_length=100)

        def reg(*a):
            return RefRiskModel(*a, n_industries=arrays.n_industries,
                                config=cfg).reg_by_time()[0]

        with ref_mesh.use_mesh(rmesh):
            ref = jax.jit(reg)(*args)
        _close("factor_ret vs reference", got[0], np.asarray(ref))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_portfolio_bias_sharded_matches_single_device(dtype):
    from mfm_tpu.models.bias import bias_std as ref_bias_std
    from mfm_tpu.models.bias import portfolio_bias_stat as ref_pbs
    from mfm_tpu_torch.models.bias import bias_std, portfolio_bias_stat

    rng = np.random.default_rng(5)
    T, N, K, Q = 64, 24, 6, 9
    X = rng.standard_normal((T, N, K))
    dval = rng.random((T, N)) < 0.9
    A = rng.standard_normal((T, K, K))
    covs = np.einsum("tik,tjk->tij", A, A) / K + np.eye(K) * 0.1
    cov_valid = rng.random(T) < 0.85
    spec = np.abs(rng.standard_normal((T, N))) * 0.02
    spec[rng.random((T, N)) < 0.15] = np.nan
    ret = 0.02 * rng.standard_normal((T, N))
    ret[rng.random((T, N)) < 0.1] = np.nan
    weights = np.abs(rng.standard_normal((Q, N)))

    def t(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
        return x if x.dtype == torch.bool else x.to(dtype)

    ins = tuple(t(x) for x in (X, dval, covs, cov_valid, spec, ret))
    bz, bok = portfolio_bias_stat(*ins, t(weights))
    base = bias_std(bz, bok)
    mesh = make_mesh(4, 2, device="cpu")
    sh = device_put(ins, NamedSharding(mesh, P("date")))
    with use_mesh(mesh):
        z, ok = portfolio_bias_stat(*sh, t(weights))
    _bitwise("ok", ok, bok)
    _bitwise("z", z, bz)
    _bitwise("bias_std", bias_std(z, ok), base)
    if dtype == torch.float64:
        rz, rok = ref_pbs(*(jnp.asarray(x) for x in (
            X, dval, covs, cov_valid, spec, ret)), jnp.asarray(weights))
        _close("bias_std vs reference", bias_std(z, ok),
               np.asarray(ref_bias_std(rz, rok)))


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_pad_to_mesh_bool_valid_pads_false(kind):
    """A bool panel pads False (never observed), as the reference's does;
    the port's padding is the reference's on the same input."""
    mesh = make_mesh(2, 4, device="cpu")
    valid = np.ones((5, 6), bool)
    x = torch.from_numpy(valid) if kind == "torch" else valid
    padded = pad_to_mesh(x, mesh)
    got = _np(padded)
    assert got.dtype == np.bool_ and got.shape == (6, 8)
    assert got[:5, :6].all()
    assert not got[5:, :].any() and not got[:, 6:].any()
    ref = np.asarray(ref_mesh.pad_to_mesh(jnp.asarray(valid),
                                          ref_mesh.make_mesh(2, 4)))
    np.testing.assert_array_equal(got, ref)
    ret = np.arange(30.0).reshape(5, 6)
    xr = torch.from_numpy(ret) if kind == "torch" else ret
    np.testing.assert_array_equal(
        _np(pad_to_mesh(xr, mesh, fill=np.nan)),
        np.asarray(ref_mesh.pad_to_mesh(jnp.asarray(ret),
                                        ref_mesh.make_mesh(2, 4),
                                        fill=np.nan)))


def _uneven_inputs(T, N, P_, Q, dtype):
    return _port_panels(synthetic_risk_inputs(T, N, P_, Q, seed=9), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_run_fused_sharded_bitwise_uneven_n999(dtype):
    """run_fused on a 2x4 mesh at N=999 (padded to 1000): bitwise the
    unsharded run at the padded shapes, all nine outputs.  The reference's
    own case fails on every run, so the port holds itself only."""
    T, N, P_, Q = 24, 999, 5, 3
    sc = torch.from_numpy(_sim_covs(1 + P_ + Q)).to(dtype)
    out, base, padded = _port_sharded_and_base(
        _uneven_inputs(T, N, P_, Q, dtype), P_, sc, 2, 4, _cfg())
    assert padded[0].shape == (T, 1000)
    for name, b, s in zip(base._fields, base, out):
        _bitwise(f"run_fused.{name}", b, s)


def _pad_stock(a, N, ns):
    w = (-N) % ns
    if not w:
        return a
    z = torch.zeros((a.shape[0], w) + tuple(a.shape[2:]), dtype=a.dtype)
    return torch.cat([a, z], dim=1)


def _state_leaves(st):
    out = []
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        stack = [v]
        while stack:
            x = stack.pop(0)
            if isinstance(x, tuple):
                stack[:0] = list(x)
            elif isinstance(x, torch.Tensor):
                out.append((f.name, x))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_update_guarded_sharded_bitwise_uneven_n999(dtype):
    """The guarded daily update on a 2x4 mesh at N=999: the stock axis
    padded to 1000 (state paths never pad time), the state on the mesh's
    first device; outputs, guard report and every state leaf bitwise the
    single-device update.  Port only (the reference's case fails)."""
    TH, SLAB, N, P_, Q = 16, 4, 999, 5, 3
    cfg = _cfg(quarantine=QuarantinePolicy(enabled=True))
    full = tuple(_pad_stock(a, N, 4)
                 for a in _uneven_inputs(TH + SLAB, N, P_, Q, dtype))
    hist = tuple(a[:TH] for a in full)
    slab = tuple(a[TH:] for a in full)
    _, state = RiskModel(*hist, n_industries=P_, config=cfg,
                         device="cpu").init_state()
    b_out, b_rep, b_st = RiskModel(*slab, n_industries=P_, config=cfg,
                                   device="cpu").update_guarded(state)
    mesh = make_mesh(2, 4, device="cpu")
    with use_mesh(mesh):
        s_out, s_rep, s_st = RiskModel(
            *shard_panel(slab, mesh), n_industries=P_, config=cfg,
            device="cpu").update_guarded(state)
    for name, b, s in zip(b_out._fields, b_out, s_out):
        _bitwise(f"out.{name}", b, s)
    for name, b, s in zip(b_rep._fields, b_rep, s_rep):
        _bitwise(f"report.{name}", b, s)
    lb, ls = _state_leaves(b_st), _state_leaves(s_st)
    assert [n for n, _ in lb] == [n for n, _ in ls]
    for (name, b), (_, s) in zip(lb, ls):
        _bitwise(f"state.{name}", b, s)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_guarded_update_steady_state_single_compile_under_mesh(arrays,
                                                               dtype):
    """On the mesh, after a warmup update (whose per-shard signatures are
    new), two further same-shape guarded updates add no event of the
    compile-contract counter, and the state they carry is bitwise the
    unsharded run's."""
    from mfm_tpu_torch.utils.contracts import (
        assert_max_compiles,
        count_compiles,
    )

    cfg = _cfg(quarantine=QuarantinePolicy(enabled=True))
    panels = _port_panels(arrays, dtype)
    TH, SLAB = 48, 4
    mesh = make_mesh(2, 4, device="cpu")
    _, state = RiskModel(*(p[:TH] for p in panels),
                         n_industries=arrays.n_industries, config=cfg,
                         device="cpu").init_state()
    plain = state

    def slab(t0):
        return tuple(p[t0:t0 + SLAB] for p in panels)

    def step(st, t0):
        with use_mesh(mesh):
            return RiskModel(*shard_panel(slab(t0), mesh),
                             n_industries=arrays.n_industries, config=cfg,
                             device="cpu").update_guarded(st)[2]

    with count_compiles():
        state = step(state, TH)              # warmup
    with assert_max_compiles(0, "guarded update steady state on mesh"):
        state = step(state, TH + SLAB)
        state = step(state, TH + 2 * SLAB)
    for t0 in (TH, TH + SLAB, TH + 2 * SLAB):
        plain = RiskModel(*slab(t0), n_industries=arrays.n_industries,
                          config=cfg, device="cpu").update_guarded(plain)[2]
    for (name, b), (_, s) in zip(_state_leaves(plain), _state_leaves(state)):
        _bitwise(f"state.{name}", b, s)


def _pipe_frame(T, N, P_, Q, seed=0, missing=0.1):
    import pandas as pd

    rng = np.random.default_rng(seed)
    dates = pd.date_range("2020-01-01", periods=T,
                          freq="B").strftime("%Y-%m-%d")
    styles = [f"st{q}" for q in range(Q)]
    rows = []
    for t in range(T):
        for j in range(N):
            if rng.random() < missing:
                continue
            row = {"date": dates[t], "stocknames": f"s{j:03d}",
                   "capital": float(np.exp(rng.normal(10, 1))),
                   "ret": float(0.01 * rng.standard_normal()),
                   "industry": f"ind{j % P_}"}
            for s in styles:
                row[s] = float(rng.standard_normal())
            rows.append(row)
    return pd.DataFrame(rows)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pipeline_shard_local_mesh_matches_dense(dtype):
    """run_risk_pipeline(mesh=) — each shard's block densified from the
    row space, no host-side dense panel — bitwise the dense run at
    T=37, N=21 (divisible by neither mesh axis); its arrays stay
    undensified through the run; within 1e-8 of the reference's mesh run
    at float64."""
    from mfm_tpu.config import PipelineConfig as RefPipelineConfig
    from mfm_tpu.pipeline import run_risk_pipeline as ref_pipeline
    from mfm_tpu_torch import PipelineConfig, run_risk_pipeline
    from mfm_tpu_torch.pipeline import LazyBarraArrays

    df = _pipe_frame(T=37, N=21, P_=4, Q=3)
    sc = _sim_covs(8, M=4, L=24)
    cfg = PipelineConfig(risk=RiskModelConfig(eigen_n_sims=4,
                                              eigen_sim_length=24),
                         dtype=dtype)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    sct = torch.from_numpy(sc).to(tdt)
    res_d = run_risk_pipeline(df, config=cfg, sim_covs=sct, device="cpu")
    res_s = run_risk_pipeline(df, config=cfg, sim_covs=sct, device="cpu",
                              mesh=make_mesh(4, 2, device="cpu"))
    assert isinstance(res_s.arrays, LazyBarraArrays)
    assert not res_s.arrays.densified
    for f in res_d.outputs._fields:
        _bitwise(f, getattr(res_s.outputs, f), getattr(res_d.outputs, f))
    assert res_s.factor_returns().shape == (37, 1 + 4 + 3)
    assert res_s.specific_returns().shape == (37, 21)
    if dtype == "float64":
        rcfg = RefPipelineConfig(risk=RefConfig(eigen_n_sims=4,
                                                eigen_sim_length=24),
                                 dtype="float64")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")
            ref = ref_pipeline(barra_df=df, config=rcfg,
                               sim_covs=jnp.asarray(sc),
                               mesh=ref_mesh.make_mesh(4, 2))
        for f in res_d.outputs._fields:
            _close(f"vs reference {f}", getattr(res_s.outputs, f),
                   np.asarray(getattr(ref.outputs, f)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pipeline_mesh_state_run_requires_divisible_shapes(dtype):
    """A state run cannot be mesh-padded: non-divisible shapes raise; at
    divisible shapes (4x1 over T=36, N=21) every state leaf is bitwise the
    dense state run's, and at float64 the outputs are within 1e-8 of the
    reference's 4x1 state run (the same injected ``sim_covs``)."""
    from mfm_tpu.config import PipelineConfig as RefPipelineConfig
    from mfm_tpu.pipeline import run_risk_pipeline as ref_pipeline
    from mfm_tpu_torch import PipelineConfig, run_risk_pipeline

    df = _pipe_frame(T=36, N=21, P_=4, Q=3)
    sc = _sim_covs(8, M=4, L=24)
    cfg = PipelineConfig(risk=RiskModelConfig(eigen_n_sims=4,
                                              eigen_sim_length=24),
                         dtype=dtype)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    kw = dict(config=cfg, device="cpu", with_state=True,
              sim_covs=torch.from_numpy(sc).to(tdt))
    with pytest.raises(ValueError, match="state"):
        run_risk_pipeline(df, mesh=make_mesh(4, 2, device="cpu"), **kw)
    res_s = run_risk_pipeline(df, mesh=make_mesh(4, 1, device="cpu"), **kw)
    res_d = run_risk_pipeline(df, **kw)
    assert res_s.state is not None
    ls, ld = _state_leaves(res_s.state), _state_leaves(res_d.state)
    assert [n for n, _ in ls] == [n for n, _ in ld]
    for (name, a), (_, b) in zip(ls, ld):
        _bitwise(f"state.{name}", a, b)
    if dtype == "float64":
        rcfg = RefPipelineConfig(risk=RefConfig(eigen_n_sims=4,
                                                eigen_sim_length=24),
                                 dtype="float64")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")
            ref = ref_pipeline(
                barra_df=df, config=rcfg, sim_covs=jnp.asarray(sc),
                with_state=True,
                mesh=ref_mesh.make_mesh(4, 1, devices=jax.devices()[:4]))
        for f in res_s.outputs._fields:
            _close(f"vs reference {f}", getattr(res_s.outputs, f),
                   np.asarray(getattr(ref.outputs, f)))


def test_config_from_reference_carries_the_mesh():
    """MeshConfig takes any shard counts; the reference's pipeline config
    carries its mesh over."""
    from mfm_tpu.config import MeshConfig as RefMesh
    from mfm_tpu.config import PipelineConfig as RefPipelineConfig
    from mfm_tpu_torch.config import MeshConfig
    from mfm_tpu_torch.convert import pipeline_config_from_reference

    ref = RefPipelineConfig(mesh=RefMesh(n_date_shards=4, n_stock_shards=2))
    got = pipeline_config_from_reference(dataclasses.asdict(ref))
    assert got.mesh == MeshConfig(4, 2)
    assert config_from_reference(
        {"mesh": {"n_date_shards": 2, "n_stock_shards": 1}}) \
        == RiskModelConfig()
    with pytest.raises(ValueError):
        MeshConfig(0, 1)
