"""The port's online filters (``cbfssm_tpu_torch.serving``:
``StreamingFilter``, ``FilterPool`` and the replay-chunk helpers)
against ``cbfssm_tpu.serving`` (CPU, float64).

The JAX filters draw tick t from ``fold_in(base_key, t)`` (forecasts
from ``2**30 + t``); the port draws from a ``torch.Generator`` seeded
``fold_seed(seed, t)`` through one method, ``_draws(index, shape)``.
:class:`JaxDraws` overrides that method with the JAX draws of the same
base key, so the two packages run the same numbers: every tick's
(mean, var), forecast and ragged replay at rtol 1e-10, and the session
table, free list, tick and key exactly. The remaining tests pin the
contracts of tests/test_filter_pool.py and tests/test_streaming.py on
the port's own draws: lockstep pool = batched StreamingFilter, slot
isolation, hold, lifecycle, validation (the JAX messages), state round
trip with another seed, replay = sequential updates at rtol 1e-12,
bucketed padding, and Voliro's two draws per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu import serving as jax_serving
from cbfssm_tpu.models import CBFSSMHALF as JaxCBFSSMHALF
from cbfssm_tpu.models import Voliro as JaxVoliro
from cbfssm_tpu_torch import convert, serving
from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF, Voliro
from cbfssm_tpu_torch.serving import (FilterPool, StreamingFilter, iter_replay_chunks,
                                      key_seed, plan_replay_chunks, seed_key)
from tests.test_other_models import half_config, voliro_batch
from tests.test_torch_other_models import params_numpy as half_numpy
from tests.test_torch_voliro import config as voliro_small_config
from tests.test_torch_voliro import params_numpy as voliro_numpy

RTOL, ATOL = 1e-10, 1e-13
SEQ_RTOL, SEQ_ATOL = 1e-12, 1e-14
RECOG, DU, DY = 4, 2, 1  # half_config's recog_len and dims
V_RECOG = 3


class JaxDraws:
    """The JAX filters' draws for tick ``index`` of this filter's base
    key: ``normal(fold_in(key, index), shape)``, and for Voliro's two
    draws (the ``FILTER_DRAWS`` axis, 4th from the end) the split
    ``kf, kx``."""

    def _draws(self, index, shape):
        key = jax.random.fold_in(jnp.asarray(self._base_key), index)

        def normal(k, s):
            return np.asarray(jax.random.normal(k, s, dtype=jnp.float64))

        if getattr(self.model, "FILTER_DRAWS", 1) == 1:
            return torch.tensor(normal(key, tuple(shape)))
        axis = len(shape) - 4
        sub = tuple(shape[:axis]) + tuple(shape[axis + 1:])
        return torch.tensor(np.stack([normal(k, sub) for k in jax.random.split(key)], axis=axis))


class JaxStream(JaxDraws, StreamingFilter):
    pass


class JaxPool(JaxDraws, FilterPool):
    pass


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def half():
    """(jax model, jax params, port model, port params): the JAX
    reference with gp_impl 'solve_free', the port with 'pallas' (the
    kernel wrapper, its plain version on the CPU)."""
    jm = JaxCBFSSMHALF(half_config("rnn"))
    params = jm.init(jax.random.PRNGKey(0))
    pm = CBFSSMHALF(dict(half_config("rnn"), gp_impl="pallas"), device="cpu")
    return jm, params, pm, convert.cbfssmhalf_params_from_numpy(half_numpy(params), device="cpu")


def prefix(rng):
    return rng.normal(size=(RECOG, DU)), rng.normal(size=(RECOG, DY))


def pool_scenario(make_pool, data):
    """One session history on a capacity-4 pool with replay ladder (3,):
    3 attaches, 2 lockstep ticks, a hold tick, a forecast, a ragged
    replay (5 and 2 steps, one session held), a detach and an attach
    into the freed slot, one more tick. Returns every output and the
    pool's bookkeeping."""
    pool = make_pool()
    prefixes, ticks, fc_u, backlog, late = data
    out = {"sids": [pool.attach(*p) for p in prefixes]}
    a, b, c = out["sids"]
    out["ticks"] = [pool.step({s: t[i] for i, s in enumerate((a, b, c))}) for t in ticks[:2]]
    out["ticks"].append(pool.step({a: ticks[2][0], c: ticks[2][2]}))
    out["forecast"] = pool.forecast({a: fc_u, b: fc_u})
    out["replay"] = pool.replay({a: backlog[0], b: backlog[1]})
    pool.detach(b)
    out["free_after_detach"] = list(pool._free)
    d = pool.attach(*late)
    out["ticks"].append(pool.step({a: ticks[3][0], c: ticks[3][2], d: ticks[3][1]}))
    out["sids"].append(d)
    out["table"] = (dict(pool._slots), list(pool._free), pool._next_sid, pool._tick)
    out["state"] = pool.state
    return out


@pytest.fixture(scope="module")
def pool_runs(half):
    jm, params, pm, tparams = half
    rng = np.random.default_rng(3)
    data = ([prefix(rng) for _ in range(3)],
            [[(rng.normal(size=DU), rng.normal(size=DY)) for _ in range(3)] for _ in range(4)],
            rng.normal(size=(5, DU)),
            [(rng.normal(size=(k, DU)), rng.normal(size=(k, DY))) for k in (5, 2)],
            prefix(rng))
    want = pool_scenario(
        lambda: jax_serving.FilterPool(jm, params, capacity=4, seed=0, replay_buckets=(3,)), data)
    got = pool_scenario(lambda: JaxPool(pm, tparams, capacity=4, seed=0, replay_buckets=(3,)),
                        data)
    return got, want


def test_pool_ticks_match_jax(pool_runs):
    got, want = pool_runs
    assert got["sids"] == want["sids"]
    for g, w in zip(got["ticks"], want["ticks"]):
        assert set(g) == set(w)
        for sid in w:
            close(g[sid][0], w[sid][0])
            close(g[sid][1], w[sid][1])


@pytest.mark.parametrize("op", ["forecast", "replay"])
def test_pool_forecast_and_ragged_replay_match_jax(pool_runs, op):
    got, want = pool_runs
    assert set(got[op]) == set(want[op])
    for sid, (wm, wv) in want[op].items():
        gm, gv = got[op][sid]
        assert gm.shape == wm.shape
        close(gm, wm)
        close(gv, wv)


def test_pool_table_and_state_match_jax(pool_runs):
    """The session table, free-list order, next sid, tick and key
    exactly; the ensemble at rtol 1e-10."""
    got, want = pool_runs
    assert got["free_after_detach"] == want["free_after_detach"]
    assert got["table"] == want["table"]
    gx, gt, gslots, gnext, gkey = got["state"]
    wx, wt, wslots, wnext, wkey = want["state"]
    assert (gt, gslots, gnext) == (wt, wslots, wnext)
    assert gkey.dtype == np.asarray(wkey).dtype and np.array_equal(gkey, np.asarray(wkey))
    close(gx, wx)


def test_streaming_filter_matches_jax(half):
    """start, 3 updates, a forecast, a 5-step replay over the ladder
    (2, 3) (chunks 3 + 2), then one more update: every output at rtol
    1e-10, the counter and key exactly."""
    jm, params, pm, tparams = half
    rng = np.random.default_rng(4)
    u, y = rng.normal(size=(2, 14, DU)), rng.normal(size=(2, 14, DY))
    outs = []
    for f in (jax_serving.StreamingFilter(jm, params, batch=2, seed=7, replay_buckets=(2, 3)),
              JaxStream(pm, tparams, batch=2, seed=7, replay_buckets=(2, 3))):
        f.start(u[:, :RECOG], y[:, :RECOG])
        res = [f.update(u[:, t - 1], y[:, t]) for t in range(RECOG, RECOG + 3)]
        res.append(f.forecast(u[:, 7:11]))
        res.append(f.replay(u[:, 6:11], y[:, 7:12]))
        res.append(f.update(u[:, 11], y[:, 12]))
        outs.append((res, f.state))
    (want, wstate), (got, gstate) = outs
    for (gm, gv), (wm, wv) in zip(got, want):
        assert tuple(gm.shape) == tuple(np.shape(wm))
        close(gm, wm)
        close(gv, wv)
    close(gstate[0], wstate[0])
    assert gstate[1] == wstate[1] == 9
    assert np.array_equal(gstate[2], np.asarray(wstate[2])) and gstate[2].dtype == np.uint32


@pytest.fixture(scope="module")
def voliro():
    cfg = voliro_small_config(filter_dt=0.01, recog_len=V_RECOG)
    jm = JaxVoliro(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    pm = Voliro(dict(cfg, gp_impl="pallas"), device="cpu")
    u, y = voliro_batch(np.random.default_rng(7), b=2, t=14)
    tparams = convert.voliro_params_from_numpy(voliro_numpy(params), device="cpu")
    return jm, params, pm, tparams, u, y


def voliro_run(stream, pool, u, y):
    stream.start(u[:, :V_RECOG], y[:, :V_RECOG])
    res = [stream.update(u[:, t - 1], y[:, t]) for t in range(V_RECOG, V_RECOG + 2)]
    res.append(stream.forecast(u[:, 5:8]))
    res.append(stream.replay(u[:, 4:7], y[:, 5:8]))
    sids = [pool.attach(u[i, :V_RECOG], y[i, :V_RECOG]) for i in range(2)]
    step = pool.step({s: (u[i, V_RECOG - 1], y[i, V_RECOG]) for i, s in enumerate(sids)})
    fc = pool.forecast({s: u[i, 4:7] for i, s in enumerate(sids)})
    rp = pool.replay({sids[0]: (u[0, 4:7], y[0, 5:8]), sids[1]: (u[1, 4:5], y[1, 5:6])})
    res += [step[s] for s in sids] + [fc[s] for s in sids] + [rp[s] for s in sids]
    return res, stream.state[0], pool.state[0]


def test_voliro_two_draws_match_jax(voliro):
    """Voliro's FILTER_DRAWS = 2 path (force and state draws): a
    StreamingFilter and a capacity-3 FilterPool against JAX's."""
    jm, params, pm, tparams, u, y = voliro
    want = voliro_run(jax_serving.StreamingFilter(jm, params, batch=2, replay_buckets=(2,)),
                      jax_serving.FilterPool(jm, params, capacity=3), u, y)
    got = voliro_run(JaxStream(pm, tparams, batch=2, replay_buckets=(2,)),
                     JaxPool(pm, tparams, capacity=3), u, y)
    for (gm, gv), (wm, wv) in zip(got[0], want[0]):
        assert tuple(gm.shape) == tuple(np.shape(wm))
        close(gm, wm)
        close(gv, wv)
    close(got[1], want[1])
    close(got[2], want[2])


def test_voliro_own_draws_replay_equals_sequential(voliro):
    _, _, pm, tparams, u, y = voliro
    seq = StreamingFilter(pm, tparams, batch=2, seed=3)
    seq.start(u[:, :V_RECOG], y[:, :V_RECOG])
    ms = np.stack([seq.update(u[:, t - 1], y[:, t])[0].numpy() for t in range(3, 8)], axis=1)
    rep = StreamingFilter(pm, tparams, batch=2, seed=3, replay_buckets=(4,))
    rep.start(u[:, :V_RECOG], y[:, :V_RECOG])
    rm, _ = rep.replay(u[:, 2:7], y[:, 3:8])
    close(rm, ms, SEQ_RTOL, SEQ_ATOL)
    close(rep.state[0], seq.state[0], SEQ_RTOL, SEQ_ATOL)


# --- the contracts of tests/test_filter_pool.py on the port's own draws ------


def test_pool_matches_batched_streaming_filter(half, rng):
    """Two sessions in a capacity-2 pool, driven in lockstep, equal one
    batch-2 StreamingFilter fed the stacked streams (same seed, same draw
    shape) at rtol 1e-12: the recognition net runs at batch 1 per attach
    against batch 2, which moves the last ulp."""
    _, _, pm, tparams = half
    pa, pb = prefix(rng), prefix(rng)
    pool = FilterPool(pm, tparams, capacity=2, seed=0)
    a, b = pool.attach(*pa), pool.attach(*pb)
    sf = StreamingFilter(pm, tparams, batch=2, seed=0)
    sf.start(np.stack([pa[0], pb[0]]), np.stack([pa[1], pb[1]]))
    close(pool.state[0], sf.state[0], SEQ_RTOL, SEQ_ATOL)
    for _ in range(3):
        u, y = rng.normal(size=(2, DU)), rng.normal(size=(2, DY))
        out = pool.step({a: (u[0], y[0]), b: (u[1], y[1])})
        mean, var = sf.update(u, y)
        close(out[a][0], mean[0], SEQ_RTOL, SEQ_ATOL)
        close(out[b][1], var[1], SEQ_RTOL, SEQ_ATOL)
        close(pool.state[0], sf.state[0], SEQ_RTOL, SEQ_ATOL)
    u_future = rng.normal(size=(5, DU))
    fc = pool.forecast({a: u_future, b: u_future})
    mean, var = sf.forecast(np.stack([u_future, u_future]))
    close(fc[a][0], mean[0], SEQ_RTOL, SEQ_ATOL)
    close(fc[b][1], var[1], SEQ_RTOL, SEQ_ATOL)


def test_slot_isolation(half, rng):
    """Session A's trajectory does not depend on its neighbour's content."""
    _, _, pm, tparams = half
    pa, other1, other2 = prefix(rng), prefix(rng), prefix(rng)
    steps = [(rng.normal(size=DU), rng.normal(size=DY)) for _ in range(2)]
    neighbour = [(rng.normal(size=DU), rng.normal(size=DY)) for _ in range(2)]

    def run(n_prefix, n_steps):
        pool = FilterPool(pm, tparams, capacity=2, seed=0)
        a, n = pool.attach(*pa), pool.attach(*n_prefix)
        outs = [pool.step({a: s, n: ns})[a] for s, ns in zip(steps, n_steps)]
        return outs, pool.state[0][0]

    outs1, row1 = run(other1, neighbour)
    outs2, row2 = run(other2, neighbour[::-1])
    for (m1, v1), (m2, v2) in zip(outs1, outs2):
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(row1, row2)


def test_hold_semantics(half, rng):
    _, _, pm, tparams = half
    pool = FilterPool(pm, tparams, capacity=2, seed=0)
    a, _b = pool.attach(*prefix(rng)), pool.attach(*prefix(rng))
    x_before = pool.state[0]
    out = pool.step({a: (rng.normal(size=DU), rng.normal(size=DY))})
    assert set(out) == {a}
    x_after = pool.state[0]
    np.testing.assert_array_equal(x_after[1], x_before[1])
    assert np.abs(x_after[0] - x_before[0]).max() > 0


def test_slot_lifecycle(half, rng):
    _, _, pm, tparams = half
    pool = FilterPool(pm, tparams, capacity=2, seed=0)
    a, b = pool.attach(*prefix(rng)), pool.attach(*prefix(rng))
    assert pool.active == 2
    with pytest.raises(RuntimeError, match="pool full"):
        pool.attach(*prefix(rng))
    pool.detach(a)
    assert pool.active == 1
    np.testing.assert_array_equal(pool.state[0][0], 0.0)
    c = pool.attach(*prefix(rng))
    assert c not in (a, b) and pool._slots[c] == 0
    with pytest.raises(KeyError):
        pool.detach(a)
    with pytest.raises(KeyError):
        pool.step({a: (np.zeros(DU), np.zeros(DY))})


@pytest.fixture(scope="module")
def twin_pools(half):
    """A JAX pool and a port pool at capacity 2, one session each."""
    jm, params, pm, tparams = half
    rng = np.random.default_rng(11)
    p = prefix(rng)
    pools = (jax_serving.FilterPool(jm, params, capacity=2, seed=0),
             FilterPool(pm, tparams, capacity=2, seed=0))
    for pool in pools:
        pool.attach(*p)
    return pools


BAD_CALLS = {
    "attach u": lambda p: p.attach(np.zeros((RECOG + 1, DU)), np.zeros((RECOG, DY))),
    "attach y": lambda p: p.attach(np.zeros((RECOG, DU)), np.zeros((RECOG, DY + 1))),
    "step shape": lambda p: p.step({0: (np.zeros(DU + 1), np.zeros(DY))}),
    "step empty": lambda p: p.step({}),
    "forecast empty": lambda p: p.forecast({}),
    "forecast du": lambda p: p.forecast({0: np.zeros((3, DU + 1))}),
    "forecast rank": lambda p: p.forecast({0: np.zeros(DU)}),
    "forecast H=0": lambda p: p.forecast({0: np.zeros((0, DU))}),
    "replay empty": lambda p: p.replay({}),
    "replay u": lambda p: p.replay({0: (np.zeros(DU), np.zeros((1, DY)))}),
    "replay y": lambda p: p.replay({0: (np.zeros((3, DU)), np.zeros((2, DY)))}),
    "state shape": lambda p: p.load_state((np.zeros((3, 3, 3)), 0, {}, 0)),
    "state dup slot": lambda p: p.load_state((np.zeros((2, 3, 3)), 0, {0: 1, 1: 1}, 2)),
    "state oob slot": lambda p: p.load_state((np.zeros((2, 3, 3)), 0, {0: 9}, 1)),
    "state next_sid": lambda p: p.load_state((np.zeros((2, 3, 3)), 0, {4: 0}, 4)),
    "state aliased": lambda p: p.load_state((np.zeros((2, 3, 3)), 0, {"0": 0, "+0": 1}, 5)),
    "state key": lambda p: p.load_state((np.zeros((2, 3, 3)), 0, {}, 0,
                                         np.zeros(3, np.uint32))),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_validation_messages_match_jax(twin_pools, case):
    """Each invalid call raises the JAX pool's exception type with its
    message, and changes nothing."""
    errors = []
    for pool in twin_pools:
        before = (dict(pool._slots), list(pool._free), pool._tick)
        with pytest.raises((ValueError, KeyError)) as e:
            BAD_CALLS[case](pool)
        errors.append((type(e.value), str(e.value)))
        assert (dict(pool._slots), list(pool._free), pool._tick) == before
    assert errors[0] == errors[1]


def test_streaming_validation_messages(half, rng):
    _, _, pm, tparams = half
    f = StreamingFilter(pm, tparams, batch=2)
    with pytest.raises(RuntimeError, match="start"):
        f.update(np.zeros((2, DU)), np.zeros((2, DY)))
    with pytest.raises(ValueError, match="prefix shape"):
        f.start(np.zeros((2, RECOG + 1, DU)), np.zeros((2, RECOG + 1, DY)))
    with pytest.raises(ValueError, match="y_prefix must be"):
        f.start(np.zeros((2, RECOG, DU)), np.zeros((2, RECOG, DY + 1)))
    f.start(rng.normal(size=(2, RECOG, DU)), rng.normal(size=(2, RECOG, DY)))
    with pytest.raises(ValueError, match="update expects"):
        f.update(np.zeros((1, DU)), np.zeros((2, DY)))
    with pytest.raises(ValueError, match="u_future must be"):
        f.forecast(np.zeros((2, DU)))
    with pytest.raises(ValueError, match="u_block"):
        f.replay(np.zeros((3, DU)), np.zeros((2, 3, DY)))
    with pytest.raises(ValueError, match="y_block"):
        f.replay(np.zeros((2, 3, DU)), np.zeros((2, 2, DY)))
    with pytest.raises(ValueError, match="at least one step"):
        f.replay(np.zeros((2, 0, DU)), np.zeros((2, 0, DY)))
    with pytest.raises(ValueError, match="ensemble must be"):
        f.load_state((np.zeros((3, 3, 3)), 0))
    with pytest.raises(ValueError, match="snapshot key"):
        f.load_state((None, 0, np.zeros(2, np.int64)))
    with pytest.raises(ValueError, match="replay_buckets"):
        StreamingFilter(pm, tparams, replay_buckets=())
    with pytest.raises(ValueError, match="replay_buckets"):
        FilterPool(pm, tparams, capacity=2, replay_buckets=(0,))
    with pytest.raises(ValueError, match="capacity"):
        FilterPool(pm, tparams, capacity=0)


@pytest.mark.parametrize("cls", [StreamingFilter, FilterPool])
def test_rejects_models_without_streaming_interface(half, cls):
    _, _, pm, tparams = half
    cbfssm = CBFSSM(dict(half_config(), var_y=np.asarray([0.5] * 3)), device="cpu")
    with pytest.raises(TypeError, match=f"{cls.__name__} supports CBFSSMHALF and Voliro"):
        cls(cbfssm, tparams, **({"capacity": 2} if cls is FilterPool else {}))


def test_mesh_is_rejected(half):
    _, _, pm, tparams = half
    with pytest.raises(ValueError, match="A6.1"):
        FilterPool(pm, tparams, capacity=4, mesh=object())


def test_pool_state_roundtrip_with_another_seed(half, rng):
    """Failover: a snapshot restored into a pool built with another seed
    continues bitwise as the uninterrupted pool (the key rides along)."""
    _, _, pm, tparams = half
    pool = FilterPool(pm, tparams, capacity=3, seed=0)
    sids = [pool.attach(*prefix(rng)) for _ in range(2)]
    stream = [{s: (rng.normal(size=DU), rng.normal(size=DY)) for s in sids} for _ in range(5)]
    for ins in stream[:2]:
        pool.step(ins)
    snapshot = pool.state
    cont = [pool.step(ins) for ins in stream[2:]]
    standby = FilterPool(pm, tparams, capacity=3, seed=99)
    standby.load_state(snapshot)
    assert standby.active == 2 and standby._free == [2]
    for o1, o2 in zip(cont, [standby.step(ins) for ins in stream[2:]]):
        for s in sids:
            np.testing.assert_array_equal(o1[s][0], o2[s][0])
            np.testing.assert_array_equal(o1[s][1], o2[s][1])
    legacy = FilterPool(pm, tparams, capacity=3, seed=0)
    legacy.load_state(snapshot[:4])  # a 4-tuple keeps this pool's key
    np.testing.assert_array_equal(legacy.step(stream[2])[sids[0]][0], cont[0][sids[0]][0])
    strly = FilterPool(pm, tparams, capacity=3, seed=0)
    strly.load_state((snapshot[0], 0, {str(s): str(v) for s, v in snapshot[2].items()}, 5))
    assert strly._slots == snapshot[2] and strly._free == [2]


def test_reload_params_equals_fresh_pool_with_state(half, rng):
    """A hot-swap keeps every session: equal to a fresh pool on the new
    params restored from the old pool's state. The new params land on
    the pool's device."""
    _, _, pm, tparams = half
    pool = FilterPool(pm, tparams, capacity=2, seed=1)
    s = pool.attach(*prefix(rng))
    pool.step({s: (rng.normal(size=DU), rng.normal(size=DY))})
    new = tparams.with_tensors([t * 1.01 for t in tparams.tensors()])
    fresh = FilterPool(pm, new, capacity=2, seed=5)
    fresh.load_state(pool.state)
    pool.reload_params(new)
    assert all(t.device == pm.device for t in pool.params.tensors())
    ins = {s: (rng.normal(size=DU), rng.normal(size=DY))}
    np.testing.assert_array_equal(pool.step(ins)[s][0], fresh.step(ins)[s][0])
    with pytest.raises(ValueError, match="leaf 0"):
        leaves = tparams.tensors()
        pool.reload_params(tparams.with_tensors([leaves[0][:1]] + leaves[1:]))


# --- replay (tests/test_streaming.py, tests/test_filter_pool.py) -------------


@pytest.fixture(scope="module")
def replay_ref(half):
    _, _, pm, tparams = half
    rng = np.random.default_rng(5)
    u, y = rng.normal(size=(2, 20, DU)), rng.normal(size=(2, 20, DY))
    ref = StreamingFilter(pm, tparams, batch=2, seed=0)
    ref.start(u[:, :RECOG], y[:, :RECOG])
    ms, vs = zip(*(ref.update(u[:, t - 1], y[:, t]) for t in range(RECOG, RECOG + 8)))
    return u, y, np.stack([m.numpy() for m in ms], 1), np.stack([v.numpy() for v in vs], 1), \
        ref.state


@pytest.mark.parametrize("buckets", [None, (2, 3), (16,)])
def test_replay_matches_sequential_updates(half, replay_ref, buckets):
    """One replay (exact, chunked 3 + 3 + 2, or padded to 16) equals 8
    sequential updates at rtol 1e-12; padding does not advance the
    counter."""
    _, _, pm, tparams = half
    u, y, seq_m, seq_v, ref_state = replay_ref
    f = StreamingFilter(pm, tparams, batch=2, seed=0, replay_buckets=buckets)
    f.start(u[:, :RECOG], y[:, :RECOG])
    m, v = f.replay(u[:, RECOG - 1:RECOG + 7], y[:, RECOG:RECOG + 8])
    assert m.shape == (2, 8, DY)
    close(m, seq_m, SEQ_RTOL, SEQ_ATOL)
    close(v, seq_v, SEQ_RTOL, SEQ_ATOL)
    close(f.state[0], ref_state[0], SEQ_RTOL, SEQ_ATOL)
    assert f.state[1] == ref_state[1] == 8


def test_replay_failover_catchup(half, replay_ref):
    """A replica restores a snapshot (another seed), replays the backlog
    since, and lands on the primary's state."""
    _, _, pm, tparams = half
    u, y, _, _, _ = replay_ref
    primary = StreamingFilter(pm, tparams, batch=2, seed=0)
    primary.start(u[:, :RECOG], y[:, :RECOG])
    primary.update(u[:, RECOG - 1], y[:, RECOG])
    snapshot = primary.state
    for t in range(RECOG + 1, RECOG + 6):
        primary.update(u[:, t - 1], y[:, t])
    replica = StreamingFilter(pm, tparams, batch=2, seed=42, replay_buckets=(4,))
    replica.load_state(snapshot)
    replica.replay(u[:, RECOG:RECOG + 5], y[:, RECOG + 1:RECOG + 6])
    close(replica.state[0], primary.state[0], SEQ_RTOL, SEQ_ATOL)
    assert replica.state[1] == primary.state[1]


def _sessions(half, **kw):
    _, _, pm, tparams = half
    rng = np.random.default_rng(7)
    data = {i: (rng.normal(size=(20, DU)), rng.normal(size=(20, DY))) for i in range(3)}
    pool = FilterPool(pm, tparams, capacity=4, seed=0, **kw)
    sids = {i: pool.attach(u[:RECOG], y[:RECOG]) for i, (u, y) in data.items()}
    return pool, sids, data


BACKLOGS = {0: 5, 1: 3}  # session 2 holds throughout


@pytest.mark.parametrize("buckets", [None, (2,)])
def test_pool_ragged_replay_matches_sequential(half, buckets):
    """Ragged backlogs in one replay equal the tick-by-tick schedule
    (tick t carries the sessions with K_i > t); the held row is bitwise
    untouched."""
    seq_pool, s_seq, data = _sessions(half)
    seq = {i: [] for i in BACKLOGS}
    for t in range(max(BACKLOGS.values())):
        ins = {s_seq[i]: (data[i][0][RECOG - 1 + t], data[i][1][RECOG + t])
               for i, k in BACKLOGS.items() if t < k}
        res = seq_pool.step(ins)
        for i in BACKLOGS:
            if s_seq[i] in res:
                seq[i].append(res[s_seq[i]])
    pool, sids, _ = _sessions(half, replay_buckets=buckets)
    held_before = pool.state[0][pool._slots[sids[2]]]
    res = pool.replay({sids[i]: (data[i][0][RECOG - 1:RECOG - 1 + k], data[i][1][RECOG:RECOG + k])
                       for i, k in BACKLOGS.items()})
    for i, k in BACKLOGS.items():
        m, v = res[sids[i]]
        assert m.shape == (k, DY)
        close(m, np.stack([mm for mm, _ in seq[i]]), SEQ_RTOL, SEQ_ATOL)
        close(v, np.stack([vv for _, vv in seq[i]]), SEQ_RTOL, SEQ_ATOL)
    close(pool.state[0], seq_pool.state[0], SEQ_RTOL, SEQ_ATOL)
    assert pool._tick == seq_pool._tick == 5
    np.testing.assert_array_equal(pool.state[0][pool._slots[sids[2]]], held_before)


class _FourMethodModel:
    """A streaming model without filter_replay."""

    def __init__(self, model):
        object.__setattr__(self, "_m", model)

    def __getattr__(self, name):
        if name == "filter_replay":
            raise AttributeError(name)
        return getattr(self._m, name)


def test_four_method_models_serve_without_replay(half, rng):
    _, _, pm, tparams = half
    f = StreamingFilter(_FourMethodModel(pm), tparams, batch=1)
    f.start(rng.normal(size=(1, RECOG, DU)), rng.normal(size=(1, RECOG, DY)))
    assert torch.isfinite(f.update(np.zeros((1, DU)), np.zeros((1, DY)))[0]).all()
    with pytest.raises(TypeError, match="filter_replay"):
        f.replay(np.zeros((1, 2, DU)), np.zeros((1, 2, DY)))
    with pytest.raises(TypeError, match="filter_replay"):
        FilterPool(_FourMethodModel(pm), tparams, capacity=1, replay_buckets=(4,))


@pytest.mark.parametrize("k_total,buckets", [(5, ()), (8, (2, 3)), (8, (16,)), (7, (2, 4)),
                                              (4, (4,)), (1, (3, 1)), (130, (16, 64))])
def test_plan_replay_chunks_matches_jax(k_total, buckets):
    assert plan_replay_chunks(k_total, buckets) == jax_serving.plan_replay_chunks(k_total, buckets)
    u = np.arange(2 * k_total * 2, dtype=float).reshape(2, k_total, 2)
    act = np.arange(k_total * 3).reshape(k_total, 3) % 2 == 0
    for full in (None, act):
        for g, w in zip(iter_replay_chunks(u, u, buckets, full),
                        jax_serving.iter_replay_chunks(u, u, buckets, full)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn,args", [("plan_replay_chunks", (0, (4,))),
                                     ("plan_replay_chunks", (3, (0, 4))),
                                     ("normalize_replay_ladder", ([],))])
def test_replay_planning_errors_match_jax(fn, args):
    errors = []
    for mod in (serving, jax_serving):
        with pytest.raises(ValueError) as e:
            getattr(mod, fn)(*args)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5, 2**64 - 1])
def test_base_key_words_are_jax_prngkey(seed):
    """The port's base key of a seed is jax.random.PRNGKey(seed)'s words
    (x64 on), and the seed comes back from them."""
    want = np.asarray(jax.random.PRNGKey(np.uint64(seed)))
    key = seed_key(seed)
    assert key.dtype == want.dtype and np.array_equal(key, want)
    assert key_seed(key) == seed


def test_draw_schedule(half):
    """Tick t draws eps of filter_step's shape from fold_seed(seed, t);
    a forecast at tick t from fold_seed(seed, 2**30 + t)."""
    _, _, pm, tparams = half
    f = StreamingFilter(pm, tparams, batch=2, seed=9)
    want = torch.randn((2, pm.samples, 1), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(serving.fold_seed(9, 3)))
    assert torch.equal(f._draws(3, f._draw_shape((), 2)), want)
    assert f._draw_shape((5,), 2) == (5, 2, pm.samples, 1)
    seen = []
    f._draws = lambda index, shape: seen.append((index, shape)) or torch.zeros(shape,
                                                                                dtype=torch.float64)
    f.start(np.zeros((2, RECOG, DU)), np.zeros((2, RECOG, DY)))
    f.update(np.zeros((2, DU)), np.zeros((2, DY)))
    f.forecast(np.zeros((2, 3, DU)))
    assert seen == [(0, (2, pm.samples, 1)), (2**30 + 1, (3, 2, pm.samples, 1))]


@pytest.mark.parametrize("cls", [StreamingFilter, FilterPool])
def test_no_fallback_without_a_card(half, cls):
    """A filter over a model on device='cuda' raises without a card: it
    never quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    _, _, _, tparams = half
    model = CBFSSMHALF(dict(half_config("rnn"), gp_impl="pallas"), device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        cls(model, tparams, **({"capacity": 2} if cls is FilterPool else {}))
