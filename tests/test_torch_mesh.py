"""The port's mesh and sharding layout (``mfm_tpu_torch/parallel/mesh.py``)
beside the reference's (``mfm_tpu/parallel/mesh.py``), on the CPU.

Covers the virtual devices (``MFM_TORCH_VIRTUAL_DEVICES``), ``make_mesh``
and its refusal when too few devices are up, ``pad_to_mesh`` against the
reference's output (bool pads False), shard and gather round trips in
every layout (bitwise), ``constrain_cross_section``,
``replicate_under_mesh``, ``PIPELINE_SPECS``, the context-local ambient
mesh and the per-shard computation of ``map_shards``.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.parallel import mesh as ref_mesh
from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV, mesh_devices
from mfm_tpu_torch.parallel import mesh as M
from mfm_tpu_torch.parallel.mesh import (
    P,
    PIPELINE_SPECS,
    Mesh,
    NamedSharding,
    ShardedPanel,
    constrain_cross_section,
    device_put,
    gather,
    make_mesh,
    make_sharded,
    map_shards,
    pad_to_mesh,
    replicate,
    replicate_under_mesh,
    shard_panel,
    use_mesh,
)


@pytest.fixture
def eight(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")


def _same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def test_virtual_devices_repeat_the_process_device(eight):
    devs = mesh_devices("cpu")
    assert devs == [torch.device("cpu")] * 8
    mesh = make_mesh(4, 2, device="cpu")
    assert mesh.shape == {"date": 4, "stock": 2}
    assert mesh.axis_names == ("date", "stock") and mesh.size == 8
    assert mesh.virtual and mesh.process_count == 1
    assert mesh.first_device == torch.device("cpu")
    assert mesh.describe() == {"mesh": "4x2", "virtual": True,
                               "devices": ["cpu"] * 8, "processes": 1}


def test_default_mesh_puts_every_device_on_the_date_axis(eight):
    assert make_mesh(device="cpu").shape == {"date": 8, "stock": 1}
    assert make_mesh(n_stock=2, device="cpu").shape == {"date": 4,
                                                        "stock": 2}


def test_without_the_variable_the_cpu_is_one_device(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    assert mesh_devices("cpu") == [torch.device("cpu")]
    one = make_mesh(1, 1, device="cpu")
    assert not one.virtual and one.size == 1


@pytest.mark.parametrize("nd,ns", [(2, 1), (1, 2), (2, 2)])
def test_too_few_devices_refuse_naming_the_variable(monkeypatch, nd, ns):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    with pytest.raises(ValueError, match=VIRTUAL_DEVICES_ENV):
        make_mesh(nd, ns, device="cpu")


@pytest.mark.parametrize("raw", ["0", "-2", "two"])
def test_a_bad_virtual_count_raises(monkeypatch, raw):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, raw)
    with pytest.raises(ValueError, match=VIRTUAL_DEVICES_ENV):
        mesh_devices("cpu")


def test_a_single_device_run_never_reads_the_variable(monkeypatch):
    """A garbage value breaks a mesh, not a run without one."""
    from mfm_tpu_torch import RiskModel, RiskModelConfig
    from mfm_tpu_torch.data.synthetic import synthetic_risk_inputs

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "garbage")
    panel = synthetic_risk_inputs(20, 12, 3, 2, seed=1)
    out = RiskModel(*panel, n_industries=3, device="cpu",
                    config=RiskModelConfig(eigen_n_sims=4)).run()
    assert out.factor_ret.shape == (20, 6)
    with pytest.raises(ValueError):
        make_mesh(2, 1, device="cpu")


def test_distinct_devices_are_not_virtual():
    mesh = Mesh(np.array([[torch.device("cpu")], [torch.device("meta")]],
                         dtype=object), ("date", "stock"))
    assert not mesh.virtual and mesh.first_device == torch.device("cpu")
    with pytest.raises(ValueError):
        Mesh(np.array([[torch.device("cpu")]], dtype=object),
             ("row", "col"))


@pytest.mark.parametrize("shape,kw", [
    ((5, 6), {}), ((8, 6), {}), ((5, 6, 3), {}), ((7,), {}),
    ((5, 6), {"rolling": True}), ((5, 6), {"fill": np.nan}),
    ((5, 6, 2), {"fill": -1.0, "rolling": True}),
])
@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_pad_to_mesh_is_the_references(eight, shape, kw, kind):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    mesh = make_mesh(2, 4, device="cpu")
    got = pad_to_mesh(torch.from_numpy(x) if kind == "torch" else x, mesh,
                      **kw)
    assert isinstance(got, torch.Tensor if kind == "torch" else np.ndarray)
    want = np.asarray(ref_mesh.pad_to_mesh(jnp.asarray(x),
                                           ref_mesh.make_mesh(2, 4), **kw))
    assert _same(got, want)


def test_pad_to_mesh_bool_pads_false_whatever_the_fill(eight):
    mesh = make_mesh(4, 2, device="cpu")
    v = torch.ones((5, 3), dtype=torch.bool)
    got = pad_to_mesh(v, mesh, fill=1)
    want = np.asarray(ref_mesh.pad_to_mesh(jnp.ones((5, 3), bool),
                                           ref_mesh.make_mesh(4, 2), fill=1))
    assert got.dtype == torch.bool and _same(got, want)
    assert not got[5:].any() and not got[:, 3:].any()
    assert pad_to_mesh(torch.ones((8, 4)), mesh).shape == (8, 4)


SPECS = [P("date", "stock"), P("date"), P(None, "stock"),
         P(None, ("date", "stock")), P(("date", "stock")), P(),
         P(("stock", "date"))]


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bool,
                                   torch.int32])
def test_shard_and_gather_round_trip_bitwise(eight, spec, dtype):
    mesh = make_mesh(2, 4, device="cpu")
    x = torch.randn(16, 24, 3, generator=torch.Generator().manual_seed(1))
    x = (x > 0) if dtype == torch.bool else x.to(dtype)
    sp = device_put(x, NamedSharding(mesh, spec))
    assert isinstance(sp, ShardedPanel) and tuple(sp.shape) == (16, 24, 3)
    assert set(sp.shards) == set(mesh.positions)
    nb = M._n_blocks(mesh, spec, 3)
    for pos, t in sp.shards.items():
        assert t.shape == tuple(n // b for n, b in zip(x.shape, nb))
        assert t.device == mesh.devices[pos]
    assert _same(gather(sp), x)


def test_device_put_refuses_an_indivisible_axis(eight):
    mesh = make_mesh(4, 2, device="cpu")
    with pytest.raises(ValueError, match="pad_to_mesh"):
        shard_panel(torch.zeros(6, 4), mesh)
    with pytest.raises(ValueError, match="axis 'model'"):
        NamedSharding(mesh, P("model"))


def test_shard_panel_maps_tuples_and_dicts(eight):
    mesh = make_mesh(2, 2, device="cpu")
    a, b = torch.ones(4, 6), torch.zeros(4, 6, 2)
    sa, sb = shard_panel((a, b), mesh)
    assert sa.spec == P("date", "stock") and tuple(sb.shape) == (4, 6, 2)
    d = shard_panel({"x": a, "y": None}, mesh)
    assert d["y"] is None and _same(gather(d["x"]), a)
    r = shard_panel(torch.ones(4, 8), mesh, rolling=True)
    assert r.spec == P(None, ("date", "stock"))
    assert r.shards[(1, 0)].shape == (4, 2)


def test_make_sharded_builds_only_each_block(eight):
    mesh = make_mesh(2, 2, device="cpu")
    full = np.arange(48, dtype=np.float32).reshape(4, 12)
    asked = []

    def cb(index):
        asked.append(index)
        return full[index]

    sp = make_sharded((4, 12), NamedSharding(mesh, P("date", "stock")), cb)
    assert len(asked) == 4
    assert all(full[i].shape == (2, 6) for i in asked)
    assert _same(gather(sp), full)
    asked.clear()
    make_sharded((4, 12), NamedSharding(mesh, P("date")), cb)
    assert len(asked) == 2       # the stock positions share a block


def test_constrain_cross_section_gathers_the_stock_axis_once(eight):
    x = torch.randn(8, 12, 2, generator=torch.Generator().manual_seed(0))
    assert constrain_cross_section(x, None) == (x, None)   # no mesh
    mesh = make_mesh(4, 2, device="cpu")
    sp = shard_panel(x, mesh)
    with use_mesh(mesh):
        got, none, plain = constrain_cross_section(sp, None, x)
    assert none is None
    for c in (got, plain):
        assert c.spec == P("date", None, None)
        for (i, j), t in c.shards.items():
            assert _same(t, x[2 * i:2 * i + 2])
        # a date row's positions share one tensor on a virtual mesh
        assert c.shards[(0, 0)] is c.shards[(0, 1)]
        assert _same(gather(c), x)


def test_replicate_under_mesh_and_replicate(eight):
    mesh = make_mesh(2, 2, device="cpu")
    x = torch.arange(8.0).reshape(4, 2)
    sp = device_put(x, NamedSharding(mesh, P("date")))
    got = replicate_under_mesh((sp, {"y": x}, [None]))
    assert _same(got[0], x) and got[1]["y"] is x and got[2] == [None]
    r = replicate(x, mesh)
    assert r.spec == P() and all(_same(t, x) for t in r.shards.values())


def test_pipeline_specs_are_the_references():
    assert set(PIPELINE_SPECS) == set(ref_mesh.PIPELINE_SPECS)
    for k, spec in ref_mesh.PIPELINE_SPECS.items():
        assert tuple(PIPELINE_SPECS[k]) == tuple(spec), k


def test_the_ambient_mesh_is_context_local(eight):
    mesh = make_mesh(2, 2, device="cpu")
    seen = {}

    def other():
        seen["thread"] = M._ambient_mesh()

    assert M._ambient_mesh() is None
    with use_mesh(mesh):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        inner = make_mesh(4, 1, device="cpu")
        with use_mesh(inner):
            assert M._ambient_mesh() is inner
        assert M._ambient_mesh() is mesh
    assert M._ambient_mesh() is None and seen["thread"] is None


def test_map_shards_runs_each_block_once_per_device(eight):
    mesh = make_mesh(2, 4, device="cpu")
    x = torch.arange(32.0).reshape(8, 4)
    calls = []

    def double(t):
        calls.append(t.shape)
        return 2 * t

    rows = device_put(x, NamedSharding(mesh, P("date")))
    out = map_shards(double, rows, out_specs=P("date"))
    assert len(calls) == 2 and _same(gather(out), 2 * x)
    calls.clear()
    spread = device_put(x, NamedSharding(mesh, P(("date", "stock"))))
    out = map_shards(double, spread, out_specs=P(("date", "stock")))
    assert len(calls) == 8 and _same(gather(out), 2 * x)
    a, b = map_shards(lambda t: (t, t.sum(dim=1)), rows,
                      out_specs=(P("date"), P("date")))
    assert tuple(b.shape) == (8,) and _same(gather(b), x.sum(dim=1))
