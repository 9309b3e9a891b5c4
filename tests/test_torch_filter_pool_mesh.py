"""``FilterPool(mesh=)`` in the port: the capacity axis sharded over a
:func:`~cbfssm_tpu_torch.parallel.local_mesh` of this process's devices
(tests/test_filter_pool.py:263, 408, 443 and
tests/test_collective_census.py:160-175 for the port).

Torch has one CPU device, so the CPU's meshes repeat it:
``local_mesh(["cpu"] * 4)`` is four row blocks, each stepped by its own
``filter_step`` call. Pinned here:

- a pool over 4 (and 2) blocks is bitwise equal to the unsharded pool
  through attaches, lockstep ticks, a held session, a forecast, a ragged
  replay over a bucket ladder, a detach and an attach into the freed
  slot (its state too);
- with the JAX draws (``JaxDraws`` of tests/test_torch_filter_pool.py)
  it equals the JAX pool on a 4-device mesh at that file's tolerances;
- a snapshot loads across topologies both ways, ``reload_params``
  replaces every block's replica, the validation errors are JAX's (and
  a ``DeviceMesh`` names ``local_mesh``), a ``FilterBatcher`` serves a
  meshed pool as it serves an unsharded one, the GP predict runs once
  per block per step, and the census of a tick and a replay is empty.

The JAX package is imported only inside the fixture that needs it, so
the ``cuda`` cases run where it does not import.
"""

import numpy as np
import pytest
import torch

from cbfssm_tpu_torch.models import CBFSSMHALF
from cbfssm_tpu_torch.ops import fused_predict as fp
from cbfssm_tpu_torch.parallel import LocalMesh, census, local_mesh
from cbfssm_tpu_torch.parallel.local import model_on, replica
from cbfssm_tpu_torch.serving import FilterBatcher, FilterPool

RTOL, ATOL = 1e-10, 1e-13  # tests/test_torch_filter_pool.py's port-against-JAX tolerance
RECOG, DU, DY = 4, 2, 1
BUCKETS = (3,)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its steps are many
    tiny ops, which 8 threads in each of the suite's 6 workers slow
    twenty-fold (the numbers do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TinyShape:
    """tests/test_cbfssm_model.TinyDS's dimensions, without JAX."""

    dim_u = DU
    dim_y = DY


def half_config(**overrides):
    """tests/test_other_models.half_config('rnn') without its JAX
    dataset class."""
    return dict({
        "ds": TinyShape, "batch_size": 2, "shuffle": 100, "dim_x": 3, "ind_pnt_num": 5,
        "samples": 3, "learning_rate": 0.01, "loss_factors": np.asarray([0.7, 0.0]),
        "k_factor": 10.0, "recog_len": RECOG, "recog_model": "rnn", "zeta_pos": 2.0,
        "zeta_mean": 0.01, "zeta_var": 0.0001, "var_x": np.asarray([0.01] * 3),
        "var_y": np.asarray([0.5]), "gp_var": 0.25, "gp_len": 1.5, "dtype": "float64",
        "jitter": 1e-8,
    }, **overrides)


def make_half(device="cpu"):
    model = CBFSSMHALF(half_config(gp_impl="pallas"), device=device)
    return model, model.init(torch.Generator(device=device).manual_seed(0))


@pytest.fixture(scope="module")
def half():
    return make_half()


def scenario_data(seed=3):
    rng = np.random.default_rng(seed)

    def prefix():
        return rng.normal(size=(RECOG, DU)), rng.normal(size=(RECOG, DY))

    return ([prefix() for _ in range(3)],
            [[(rng.normal(size=DU), rng.normal(size=DY)) for _ in range(3)] for _ in range(4)],
            rng.normal(size=(5, DU)),
            [(rng.normal(size=(k, DU)), rng.normal(size=(k, DY))) for k in (5, 2)],
            prefix())


def pool_scenario(pool, data):
    """One session history on a capacity-4 pool: 3 attaches, 2 lockstep
    ticks, a tick holding session b, a forecast, a ragged replay (5 and
    2 steps, c held), a detach and an attach into the freed slot, one
    more tick. Returns every output, the bookkeeping and the state."""
    prefixes, ticks, fc_u, backlog, late = data
    out = {"sids": [pool.attach(*p) for p in prefixes]}
    out["attach_state"] = pool.state[0]
    a, b, c = out["sids"]
    out["ticks"] = [pool.step({s: t[i] for i, s in enumerate((a, b, c))}) for t in ticks[:2]]
    out["ticks"].append(pool.step({a: ticks[2][0], c: ticks[2][2]}))
    out["forecast"] = pool.forecast({a: fc_u, b: fc_u})
    out["replay"] = pool.replay({a: backlog[0], b: backlog[1]})
    pool.detach(b)
    d = pool.attach(*late)
    out["ticks"].append(pool.step({a: ticks[3][0], c: ticks[3][2], d: ticks[3][1]}))
    out["sids"].append(d)
    out["table"] = (dict(pool._slots), list(pool._free), pool._next_sid, pool._tick)
    out["state"] = pool.state
    return out


def assert_outputs(got, want, check):
    """``check(got, want)`` on every array of two scenario outputs; the
    session ids, table, tick and key exactly."""
    assert got["sids"] == want["sids"] and got["table"] == want["table"]
    check(got["attach_state"], want["attach_state"])
    for g, w in zip(got["ticks"], want["ticks"], strict=True):
        assert set(g) == set(w)
        for sid in w:
            check(g[sid][0], w[sid][0])
            check(g[sid][1], w[sid][1])
    for op in ("forecast", "replay"):
        assert set(got[op]) == set(want[op])
        for sid, (wm, wv) in want[op].items():
            check(got[op][sid][0], wm)
            check(got[op][sid][1], wv)
    gx, gt, gslots, gnext, gkey = got["state"]
    wx, wt, wslots, wnext, wkey = want["state"]
    check(gx, wx)
    assert (gt, gslots, gnext) == (wt, wslots, wnext)
    assert np.array_equal(gkey, np.asarray(wkey))


def bitwise(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def unsharded_run(half):
    model, params = half
    return pool_scenario(FilterPool(model, params, capacity=4, seed=0,
                                    replay_buckets=BUCKETS), scenario_data())


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_meshed_pool_equals_unsharded_bitwise(half, unsharded_run, n_blocks):
    model, params = half
    pool = FilterPool(model, params, capacity=4, seed=0, mesh=local_mesh(["cpu"] * n_blocks),
                      replay_buckets=BUCKETS)
    assert len(pool._x) == n_blocks and all(x.shape[0] == 4 // n_blocks for x in pool._x)
    assert_outputs(pool_scenario(pool, scenario_data()), unsharded_run, bitwise)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_meshed_solve_free_pool_within_c9(n_blocks):
    """The solve-free GP predict (``kernels.scaled_square_dist``'s
    ``xs @ zs.T``) is bitwise equal to the unsharded pool at 2 and 4
    blocks, as JAX pins it (ROADMAP C9, repaired: CPU BLAS takes another
    path for a transposed right operand at 2-4 rows, so the CPU operand is
    made contiguous)."""
    model = CBFSSMHALF(half_config(gp_impl="solve_free"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    want = pool_scenario(FilterPool(model, params, capacity=4, seed=0,
                                    replay_buckets=BUCKETS), scenario_data())
    got = pool_scenario(FilterPool(model, params, capacity=4, seed=0,
                                   mesh=local_mesh(["cpu"] * n_blocks),
                                   replay_buckets=BUCKETS), scenario_data())
    assert_outputs(got, want, bitwise)


def test_meshed_pool_matches_jax_pool_on_a_mesh(half):
    """The port's pool over 4 blocks with the JAX draws against the JAX
    pool on a 4-device mesh, the same params."""
    pytest.importorskip("flax")
    import jax

    from cbfssm_tpu import serving as jax_serving
    from cbfssm_tpu.models import CBFSSMHALF as JaxCBFSSMHALF
    from cbfssm_tpu.parallel.sharding import make_mesh
    from cbfssm_tpu_torch import convert
    from tests.test_other_models import half_config as jax_half_config
    from tests.test_torch_filter_pool import JaxPool
    from tests.test_torch_other_models import params_numpy

    jm = JaxCBFSSMHALF(jax_half_config("rnn"))
    params = jm.init(jax.random.PRNGKey(0))
    tparams = convert.cbfssmhalf_params_from_numpy(params_numpy(params), device="cpu")
    model, _ = half
    data = scenario_data()
    want = pool_scenario(jax_serving.FilterPool(jm, params, capacity=4, seed=0,
                                                mesh=make_mesh(4), replay_buckets=BUCKETS), data)
    got = pool_scenario(JaxPool(model, tparams, capacity=4, seed=0,
                                mesh=local_mesh(["cpu"] * 4), replay_buckets=BUCKETS), data)

    def close(g, w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL, atol=ATOL)

    assert_outputs(got, want, close)


def stepped_pool(half, mesh, rng_seed=5):
    """A capacity-4 pool with 3 sessions and 2 ticks."""
    model, params = half
    rng = np.random.default_rng(rng_seed)
    pool = FilterPool(model, params, capacity=4, seed=0, mesh=mesh)
    sids = [pool.attach(rng.normal(size=(RECOG, DU)), rng.normal(size=(RECOG, DY)))
            for _ in range(3)]
    for _ in range(2):
        pool.step({s: (rng.normal(size=DU), rng.normal(size=DY)) for s in sids})
    return pool, sids


@pytest.mark.parametrize("direction", ["mesh_to_flat", "flat_to_mesh"])
def test_state_loads_across_topologies(half, direction):
    """A snapshot of one topology resumes on the other (with another
    seed: the key rides along) and both continue bitwise alike."""
    model, params = half
    mesh = local_mesh(["cpu"] * 4)
    src_mesh, dst_mesh = (mesh, None) if direction == "mesh_to_flat" else (None, mesh)
    src, sids = stepped_pool(half, src_mesh)
    dst = FilterPool(model, params, capacity=4, seed=9, mesh=dst_mesh)
    dst.load_state(src.state)
    bitwise(dst.state[0], src.state[0])
    rng = np.random.default_rng(1)
    ins = {s: (rng.normal(size=DU), rng.normal(size=DY)) for s in sids[:2]}
    for pool_out in zip(src.step(ins).items(), dst.step(ins).items()):
        (sa, (ma, va)), (sb, (mb, vb)) = pool_out
        assert sa == sb
        bitwise(ma, mb)
        bitwise(va, vb)
    u = rng.normal(size=(3, DU))
    fa, fb = src.forecast({sids[2]: u}), dst.forecast({sids[2]: u})
    bitwise(fa[sids[2]][0], fb[sids[2]][0])
    bitwise(src.state[0], dst.state[0])


def test_reload_params_replaces_every_replica(half):
    """A meshed pool's hot swap equals an unsharded pool's, and a fresh
    meshed pool with the new params restored from its state."""
    model, _ = half
    new = model.init(torch.Generator().manual_seed(1))
    mesh = local_mesh(["cpu"] * 4)
    pools = {"mesh": stepped_pool(half, mesh)[0], "flat": stepped_pool(half, None)[0]}
    fresh = FilterPool(model, new, capacity=4, seed=0, mesh=mesh)
    fresh.load_state(pools["mesh"].state)
    for pool in pools.values():
        pool.reload_params(new)
    rng = np.random.default_rng(2)
    ins = {s: (rng.normal(size=DU), rng.normal(size=DY)) for s in (0, 1, 2)}
    outs = [p.step(ins) for p in (pools["mesh"], pools["flat"], fresh)]
    for sid in ins:
        for o in outs[1:]:
            bitwise(outs[0][sid][0], o[sid][0])
            bitwise(outs[0][sid][1], o[sid][1])


def test_replicas_for_another_device(half):
    """What a block on another card reads, copied there (the CPU's blocks
    all share its one device, so the pool never copies here; the meta
    device stands in for a second card): the model with its device and
    tensor constants moved, the operators leaf for leaf, the original
    untouched."""
    model, params = half
    model.scale = torch.ones(3, dtype=torch.float64)
    try:
        moved = model_on(model, "meta")
        assert moved is not model and moved.device == torch.device("meta")
        assert moved.scale.device.type == "meta" and model.scale.device.type == "cpu"
        assert model.device == torch.device("cpu") and model_on(model, "cpu") is model
    finally:
        del model.scale
    ops = model.filter_ops(params)
    copied = replica(ops, "meta")
    assert type(copied) is type(ops) and type(copied[0]) is type(ops[0])
    for a, b in zip(torch.utils._pytree.tree_leaves(list(ops[1:])) + list(vars(ops[0]).values()),
                    torch.utils._pytree.tree_leaves(list(copied[1:]))
                    + list(vars(copied[0]).values())):
        assert b.device.type == "meta" and a.device.type == "cpu" and a.shape == b.shape


def test_mesh_validation(half):
    """tests/test_filter_pool.py:443's errors, and a mesh that is not a
    local one."""
    from torch.distributed.device_mesh import DeviceMesh

    model, params = half
    mesh = local_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        FilterPool(model, params, capacity=3, mesh=mesh)
    with pytest.raises(ValueError, match="no axis"):
        FilterPool(model, params, capacity=4, mesh=mesh, axis_name="model")
    with pytest.raises(ValueError, match="local_mesh"):
        FilterPool(model, params, capacity=4, mesh=object.__new__(DeviceMesh))
    with pytest.raises(ValueError, match="local_mesh"):
        FilterPool(model, params, capacity=4, mesh=object())
    with pytest.raises(ValueError, match="at least one device"):
        local_mesh([])
    named = local_mesh(["cpu", "cpu"], axis_name="fleet")
    assert isinstance(named, LocalMesh) and named.shape == {"fleet": 2}
    assert named.axis_names == ("fleet",) and named.devices == (torch.device("cpu"),) * 2
    assert FilterPool(model, params, capacity=4, mesh=named, axis_name="fleet").mesh is named


def test_batcher_serves_a_meshed_pool(half):
    """FilterBatcher over a meshed pool: attaches, coalesced steps and a
    forecast equal the unsharded pool driven directly."""
    model, params = half
    rng = np.random.default_rng(4)
    prefixes = [(rng.normal(size=(RECOG, DU)), rng.normal(size=(RECOG, DY))) for _ in range(3)]
    ticks = [[(rng.normal(size=DU), rng.normal(size=DY)) for _ in range(3)] for _ in range(2)]
    u_fc = rng.normal(size=(4, DU))
    flat = FilterPool(model, params, capacity=4, seed=0)
    sids = [flat.attach(*p) for p in prefixes]
    want = [flat.step(dict(zip(sids, t))) for t in ticks]
    want_fc = flat.forecast({sids[0]: u_fc})
    pool = FilterPool(model, params, capacity=4, seed=0, mesh=local_mesh(["cpu"] * 4))
    with FilterBatcher(pool, max_wait_ms=50.0) as batcher:
        got_sids = [batcher.attach(*p).result(timeout=60) for p in prefixes]
        assert got_sids == sids
        for t, w in zip(ticks, want):
            futs = [batcher.step(s, *t[i]) for i, s in enumerate(sids)]
            for s, f in zip(sids, futs):
                mean, var = f.result(timeout=60)
                bitwise(mean, w[s][0])
                bitwise(var, w[s][1])
        mean, var = batcher.forecast(sids[0], u_fc).result(timeout=60)
    bitwise(mean, want_fc[sids[0]][0])
    bitwise(var, want_fc[sids[0]][1])
    bitwise(pool.state[0], flat.state[0])


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_predicts_per_block_and_an_empty_census(half, monkeypatch, n_blocks):
    """A tick, a forecast step and a replay step run the GP predict once
    per block (the unsharded pool's count times the blocks) and perform
    no collective (tests/test_collective_census.py:160-175)."""
    calls = []
    run = fp._run

    def counting(name, *args, **kwargs):
        calls.append(name)
        return run(name, *args, **kwargs)

    monkeypatch.setattr(fp, "_run", counting)
    model, params = half
    rng = np.random.default_rng(6)
    counts = {}
    for name, mesh in (("flat", None), ("mesh", local_mesh(["cpu"] * n_blocks))):
        pool = FilterPool(model, params, capacity=4, seed=0, mesh=mesh, replay_buckets=(4,))
        sids = [pool.attach(rng.normal(size=(RECOG, DU)), rng.normal(size=(RECOG, DY)))
                for _ in range(4)]
        calls.clear()
        with census.record() as items:
            pool.step({s: (rng.normal(size=DU), rng.normal(size=DY)) for s in sids})
            tick = len(calls)
            pool.forecast({sids[0]: rng.normal(size=(2, DU))})
            fc = len(calls) - tick
            pool.replay({sids[1]: (rng.normal(size=(3, DU)), rng.normal(size=(3, DY)))})
            rp = len(calls) - tick - fc
        assert items == [], census.describe(items)
        assert set(calls) == {"gp_predict"}
        counts[name] = (tick, fc, rp)
    blocks = n_blocks
    assert counts["flat"] == (1, 2, 4)  # a tick, 2 forecast steps, a 4-step replay bucket
    assert counts["mesh"] == tuple(blocks * c for c in counts["flat"])


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [1, 2])
def test_cuda_meshed_pool_equals_unsharded(cuda_device, n_blocks):
    """The kernel path: a pool over ``local_mesh(["cuda:0"] * n)``
    against the unsharded pool on the card, bitwise, every tick's
    ``gp_predict`` launched once per block."""
    model, params = make_half("cuda")
    want = pool_scenario(FilterPool(model, params, capacity=4, seed=0,
                                    replay_buckets=BUCKETS), scenario_data())
    before = fp.fused_predict.launches
    pool = FilterPool(model, params, capacity=4, seed=0,
                      mesh=local_mesh([cuda_device] * n_blocks), replay_buckets=BUCKETS)
    got = pool_scenario(pool, scenario_data())
    launches = fp.fused_predict.launches - before
    assert_outputs(got, want, bitwise)
    # 3 attaches run the recognition net only; 4 ticks, a 5-step forecast
    # and a replay of 5 steps (2 chunks of the (3,) ladder: 6 steps)
    assert launches == n_blocks * (4 + 5 + 6)
