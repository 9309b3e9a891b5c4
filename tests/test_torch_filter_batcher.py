"""The port's ``FilterBatcher`` (``cbfssm_tpu_torch.serving``) on a tiny
CBFSSMHALF (CPU, float64): the contracts of tests/test_filter_batcher.py.

Sequential operations through the batcher equal the bare pool's
schedule; coalesced groups equal a bare pool fed the same recorded
groups in the same order (bitwise); a session never rides one dispatch
twice; an unknown session fails only its own future; lifecycle and
failover items serialize with fleet dispatches; close / drain; and the
submit-side messages and ``stats()`` keys are the JAX batcher's.
"""

import threading

import jax
import numpy as np
import pytest

from cbfssm_tpu import serving as jax_serving
from cbfssm_tpu.models import CBFSSMHALF as JaxCBFSSMHALF
from cbfssm_tpu_torch import convert
from cbfssm_tpu_torch.models import CBFSSMHALF
from cbfssm_tpu_torch.serving import FilterBatcher, FilterPool
from tests.test_other_models import half_config
from tests.test_torch_other_models import params_numpy

RECOG, DU, DY = 4, 2, 1  # half_config's recog_len and dims
TIMEOUT = 30


@pytest.fixture(scope="module")
def mp():
    """(port model, port params, jax model, jax params)."""
    jm = JaxCBFSSMHALF(half_config("rnn"))
    params = jm.init(jax.random.PRNGKey(0))
    pm = CBFSSMHALF(dict(half_config("rnn"), gp_impl="pallas"), device="cpu")
    return pm, convert.cbfssmhalf_params_from_numpy(params_numpy(params), device="cpu"), jm, params


def prefix(rng):
    return rng.normal(size=(RECOG, DU)), rng.normal(size=(RECOG, DY))


def pool(mp, capacity=2, seed=0):
    return FilterPool(mp[0], mp[1], capacity=capacity, seed=seed)


def assert_pair_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_sequential_ops_match_bare_pool(mp, rng):
    """Awaiting each future before the next submission makes every
    group a singleton: attach, 3 steps, a forecast, a replay and a
    detach replay the bare pool's schedule exactly."""
    pa = prefix(rng)
    steps = [(rng.normal(size=DU), rng.normal(size=DY)) for _ in range(3)]
    u_future = rng.normal(size=(5, DU))
    backlog = (rng.normal(size=(4, DU)), rng.normal(size=(4, DY)))
    bare = pool(mp)
    a0 = bare.attach(*pa)
    want = [bare.step({a0: s})[a0] for s in steps]
    want += [bare.forecast({a0: u_future})[a0], bare.replay({a0: backlog})[a0]]
    with FilterBatcher(pool(mp), max_wait_ms=0.0) as fb:
        a = fb.attach(*pa).result(TIMEOUT)
        assert a == a0
        got = [fb.step(a, *s).result(TIMEOUT) for s in steps]
        got += [fb.forecast(a, u_future).result(TIMEOUT),
                fb.replay(a, *backlog).result(TIMEOUT)]
        assert fb.detach(a).result(TIMEOUT) is None
        assert fb.pool.active == 0
    for g, w in zip(got, want):
        assert_pair_equal(g, w)


@pytest.mark.parametrize("kind", ["step", "forecast", "replay"])
def test_coalesced_groups_match_group_replay(mp, rng, kind):
    """Whatever grouping the dispatcher forms, each result equals a bare
    pool fed the same recorded group dicts in the same order."""
    prefixes = [prefix(rng) for _ in range(3)]
    payloads = {
        "step": [(rng.normal(size=DU), rng.normal(size=DY)) for _ in range(3)],
        "forecast": [(rng.normal(size=(4, DU)),) for _ in range(3)],
        "replay": [(rng.normal(size=(k, DU)), rng.normal(size=(k, DY))) for k in (3, 1, 2)],
    }[kind]
    served = pool(mp, capacity=3)
    recorded = []
    orig = getattr(served, kind)

    def record(d):
        recorded.append(dict(d))
        return orig(d)

    sids = [served.attach(*p) for p in prefixes]  # attached first: no collect window
    setattr(served, kind, record)
    with FilterBatcher(served, max_wait_ms=1000.0) as fb:
        futs = [getattr(fb, kind)(s, *p) for s, p in zip(sids, payloads)]
        got = {s: f.result(TIMEOUT) for s, f in zip(sids, futs)}
        assert fb.stats()["max_group_seen"] == 3  # the three coalesced
    bare = pool(mp, capacity=3)
    remap = {s: bare.attach(*p) for s, p in zip(sids, prefixes)}
    want = {}
    for grp in recorded:
        out = getattr(bare, kind)({remap[s]: v for s, v in grp.items()})
        want.update({s: out[remap[s]] for s in grp})
    for s in sids:
        assert_pair_equal(got[s], want[s])


def test_same_session_fifo_uses_two_ticks(mp, rng):
    """Two pending steps of one session never share a dispatch: they
    resolve to the bare pool's two-tick schedule."""
    pa = prefix(rng)
    s1 = (rng.normal(size=DU), rng.normal(size=DY))
    s2 = (rng.normal(size=DU), rng.normal(size=DY))
    bare = pool(mp)
    a0 = bare.attach(*pa)
    w1, w2 = bare.step({a0: s1})[a0], bare.step({a0: s2})[a0]
    served = pool(mp)
    a = served.attach(*pa)
    with FilterBatcher(served, max_wait_ms=1000.0) as fb:
        f1, f2 = fb.step(a, *s1), fb.step(a, *s2)
        g1, g2 = f1.result(TIMEOUT), f2.result(TIMEOUT)
        assert fb.pool._tick == 2
        assert fb.stats()["max_group_seen"] == 1
    assert_pair_equal(g1, w1)
    assert_pair_equal(g2, w2)


def test_unknown_session_fails_only_its_future(mp, rng):
    served = pool(mp)
    a = served.attach(*prefix(rng))
    with FilterBatcher(served, max_wait_ms=1000.0) as fb:
        good = fb.step(a, rng.normal(size=DU), rng.normal(size=DY))
        bad = fb.step(999, rng.normal(size=DU), rng.normal(size=DY))
        mean, var = good.result(TIMEOUT)
        assert np.all(np.isfinite(mean)) and np.all(var > 0)
        with pytest.raises(KeyError, match="unknown session 999"):
            bad.result(TIMEOUT)
        assert fb.stats()["errors"] == 1


@pytest.fixture(scope="module")
def twin_batchers(mp):
    """A JAX and a port FilterBatcher (capacity 1), one session each."""
    pm, tparams, jm, params = mp
    p = prefix(np.random.default_rng(1))
    batchers = (jax_serving.FilterBatcher(jax_serving.FilterPool(jm, params, capacity=1),
                                          max_wait_ms=0.0),
                FilterBatcher(FilterPool(pm, tparams, capacity=1), max_wait_ms=0.0))
    sids = [fb.attach(*p).result(TIMEOUT) for fb in batchers]
    assert sids == [0, 0]
    yield batchers
    for fb in batchers:
        fb.close()


BAD_SUBMITS = {
    "attach u": lambda fb: fb.attach(np.zeros((RECOG + 1, DU)), np.zeros((RECOG, DY))),
    "attach y": lambda fb: fb.attach(np.zeros((RECOG, DU)), np.zeros((RECOG, DY + 1))),
    "step": lambda fb: fb.step(0, np.zeros(DU + 1), np.zeros(DY)),
    "forecast H=0": lambda fb: fb.forecast(0, np.zeros((0, DU))),
    "forecast rank": lambda fb: fb.forecast(0, np.zeros(DU)),
    "replay u": lambda fb: fb.replay(0, np.zeros((3, DU + 1)), np.zeros((3, DY))),
    "replay y": lambda fb: fb.replay(0, np.zeros((3, DU)), np.zeros((2, DY))),
}


@pytest.mark.parametrize("case", sorted(BAD_SUBMITS))
def test_submit_side_messages_match_jax(twin_batchers, case):
    errors = []
    for fb in twin_batchers:
        with pytest.raises(ValueError) as e:
            BAD_SUBMITS[case](fb)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_stats_keys_match_jax(twin_batchers):
    jax_fb, fb = twin_batchers
    for b in twin_batchers:
        b.step(0, np.zeros(DU), np.zeros(DY)).result(TIMEOUT)
    s, want = fb.stats(), jax_fb.stats()
    assert sorted(s) == sorted(want)
    assert {k: s[k] for k in ("requests", "dispatches", "errors", "max_group_seen")} == \
        {k: want[k] for k in ("requests", "dispatches", "errors", "max_group_seen")}


def test_mixed_horizon_forecasts_both_resolve(mp, rng):
    served = pool(mp)
    a, b = served.attach(*prefix(rng)), served.attach(*prefix(rng))
    with FilterBatcher(served, max_wait_ms=1000.0) as fb:
        fa = fb.forecast(a, rng.normal(size=(3, DU)))
        fc = fb.forecast(b, rng.normal(size=(5, DU)))
        assert fa.result(TIMEOUT)[0].shape == (3, DY)
        assert fc.result(TIMEOUT)[0].shape == (5, DY)


def test_state_roundtrip_and_reload_through_batcher(mp, rng):
    """A snapshot taken through the batcher restores into a fresh pool
    built with another seed and continues bitwise; a hot-swap through
    the batcher keeps the session."""
    pa = prefix(rng)
    s1, s2, s3 = [(rng.normal(size=DU), rng.normal(size=DY)) for _ in range(3)]
    new = mp[1].with_tensors([t * 1.01 for t in mp[1].tensors()])
    with FilterBatcher(pool(mp), max_wait_ms=0.0) as fb:
        a = fb.attach(*pa).result(TIMEOUT)
        fb.step(a, *s1).result(TIMEOUT)
        snap = fb.state().result(TIMEOUT)
        want = fb.step(a, *s2).result(TIMEOUT)
        assert fb.reload_params(new).result(TIMEOUT) is None
        want3 = fb.step(a, *s3).result(TIMEOUT)
    with FilterBatcher(pool(mp, seed=77), max_wait_ms=0.0) as fb2:
        assert fb2.load_state(snap).result(TIMEOUT) is None
        assert_pair_equal(fb2.step(a, *s2).result(TIMEOUT), want)
        fb2.reload_params(new).result(TIMEOUT)
        assert_pair_equal(fb2.step(a, *s3).result(TIMEOUT), want3)


def test_close_semantics(mp, rng):
    fb = FilterBatcher(pool(mp, capacity=1), max_wait_ms=0.0)
    a = fb.attach(*prefix(rng)).result(TIMEOUT)
    fb.close()
    fb.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        fb.step(a, np.zeros(DU), np.zeros(DY))
    # drain=False fails pending futures: stall the dispatcher on a live
    # step so the probe stays queued behind it
    fb2 = FilterBatcher(pool(mp, capacity=1), max_wait_ms=0.0)
    b = fb2.attach(*prefix(rng)).result(TIMEOUT)
    gate, entered = threading.Event(), threading.Event()
    orig = fb2.pool.step

    def slow_step(d):
        entered.set()
        gate.wait(timeout=TIMEOUT)
        return orig(d)

    fb2.pool.step = slow_step
    running = fb2.step(b, np.zeros(DU), np.zeros(DY))
    assert entered.wait(timeout=TIMEOUT)
    pending = fb2.step(b, np.ones(DU), np.ones(DY))
    closer = threading.Thread(target=lambda: fb2.close(drain=False))
    closer.start()
    while not pending.done():
        pass
    gate.set()
    closer.join(timeout=TIMEOUT)
    assert running.result(TIMEOUT) is not None
    with pytest.raises(RuntimeError, match="closed before dispatch"):
        pending.result(TIMEOUT)


def test_stats_shape_and_lifecycle_wait(mp, rng):
    with FilterBatcher(pool(mp, capacity=1), max_wait_ms=0.0) as fb:
        a = fb.attach(*prefix(rng)).result(TIMEOUT)
        fb.step(a, np.zeros(DU), np.zeros(DY)).result(TIMEOUT)
        fb.detach(a).result(TIMEOUT)
        s = fb.stats()
    assert s["requests"] == 3 and s["dispatches"] == 3
    assert s["errors"] == 0 and s["mean_group_size"] == 1.0
    assert s["max_group_seen"] == 1 and s["mean_wait_ms"] > 0.0
