"""CUDA graphs of the port's Trainer step (``training/step_graph.py``).

On the CPU (this file imports no JAX, so its ``cuda`` tests run on the
card with ``--noconftest``):

- the device constants that replace the step's host-to-device copies
  equal what was uploaded before (``segmentation``'s masks, the hand
  adjoint's schedule flags, the quaternion sign vector), per shape and
  dtype; each is made once, and anew under ``torch.export``'s fake
  tensors; ``quaternion.conjugate`` and ``rotate_vector`` are unchanged;
- ``draw_noise(..., out=)`` draws the numbers ``draw_noise`` draws, and
  a ``StaticBatch`` stages them from a generator or copies ``noise_fn``'s;
- the eligibility rule (a CUDA device, no mesh, no ``ParticleParallel``);
  a CPU Trainer runs every step and test batch eagerly and counts them,
  in ``graph_counts()`` and the ``done`` event of ``metrics.jsonl``;
- ``step.capture`` and ``step.replay`` have phases in ``SPAN_PHASES``;
- the leaves and Adam's state are the Trainer's for its life: ``train()``,
  ``retrain=True`` and ``restore()`` write into them the numbers a new
  Trainer's would hold;
- ``profiling.recording()`` follows the profiler.

On the card (``cuda``): a graphed Trainer against the same Trainer made
ineligible, for CBFSSM (kernel; ``solve_free`` with the hand adjoint),
CBFSSMHALF, PRSSM and Voliro, at ``epochs_per_dispatch`` 1 and 4 with a
ragged last batch: per-epoch losses, leaves, Adam state and both
checkpoints bitwise equal, no fallback, as many GP kernel launches (the
wrappers' own and the replays'); a guard-skipped non-finite batch
(through ``noise_fn``); ``retrain=True`` and ``restore()`` replaying the
graphs captured before; a profiler trace started after the capture and
settled before its stop sees every kernel of a replay, its GP kernels as
many as the graph says it replayed.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF, PRSSM, Voliro, segmentation
from cbfssm_tpu_torch.models.base import noise_tensors
from cbfssm_tpu_torch.ops import quaternion
from cbfssm_tpu_torch.training import Trainer, checkpoint, step_graph
from cbfssm_tpu_torch.training.trainer import SPAN_PHASES
from cbfssm_tpu_torch.utils import profiling, transfer
import torch_parallel_workers as workers  # tests/ (pytest puts it on sys.path)
from test_torch_distributed import smoke_arrays, smoke_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps are many tiny ops (see
    tests/test_torch_blocked_epochs.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds():
    return workers.Windows(**smoke_arrays())  # 28 train windows: 3 batches of 8 and 4


class VoliroShape:
    dim_u = 13
    dim_y = 22


def voliro_config(**overrides):
    """tests/test_other_models.voliro_config without JAX."""
    return dict({
        "ds": VoliroShape, "batch_size": 4, "shuffle": 100, "ind_pnt_num": 4, "samples": 3,
        "learning_rate": 0.01, "loglik_factor": np.asarray([20.0, 0.0, 200.0]),
        "n_beta": [10.0, 2.0, 10.0], "l_beta": [1.0, 10.0, 10.0], "zeta_pos": 2.0,
        "zeta_mean": 0.0025, "zeta_var": 0.0001, "gp_var": 0.25, "gp_len": 5.0,
        "var_x": np.asarray([0.02] * 7 + [0.2] * 6) ** 2,
        "var_y": np.asarray([0.02] * 7 + [0.2] * 6) ** 2,
        "var_z": np.asarray([0.02] * 6), "dtype": "float64", "jitter": 1e-8,
    }, **overrides)


def voliro_batch(rng, b, t=6):
    """tests/test_other_models.voliro_batch: rotor inputs with a time
    channel, observations with unit quaternions."""
    pwm = rng.uniform(0.3, 0.9, size=(b, t, 6))
    tilt = rng.uniform(-0.5, 0.5, size=(b, t, 6))
    tgrid = np.broadcast_to(np.arange(t, dtype=np.float64)[None, :, None] * 0.01, (b, t, 1))
    u = np.concatenate((pwm, tilt, tgrid), axis=-1)
    y = rng.normal(size=(b, t, 22)) * 0.1
    q = rng.normal(size=(b, t, 4))
    y[..., 12:16] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return u, y


def voliro_ds():
    """10 train windows (batches of 4, 4 and a ragged 2), 6 test."""
    rng = np.random.default_rng(5)
    u, y = voliro_batch(rng, 10)
    tu, ty = voliro_batch(rng, 6)
    return workers.Windows(train_in_batch=u, train_out_batch=y, test_in_batch=tu,
                           test_out_batch=ty)


MODELS = {
    "cbfssm_pallas": lambda device: CBFSSM(smoke_config(gp_impl="pallas"), device=device),
    "cbfssm_hand": lambda device: CBFSSM(smoke_config(adjoint="hand"), device=device),
    "cbfssmhalf": lambda device: CBFSSMHALF(smoke_config(var_y=[1.0]), device=device),
    "prssm": lambda device: PRSSM(smoke_config(var_y=[1.0]), device=device),
    "voliro": lambda device: Voliro(voliro_config(), device=device),
}


def data_for(kind, ds):
    return voliro_ds() if kind == "voliro" else ds


# --- device constants -------------------------------------------------------------


@pytest.mark.parametrize("t_len,recog_len", [(12, 4), (30, 5), (7, 4)])
def test_cbfssm_constants_equal_the_masks(t_len, recog_len):
    """A CBFSSM loss on both recognition schedules and the hand adjoint's
    backward leave constants equal to the masks they replace."""
    transfer._CONSTANTS.clear()
    u = torch.randn(2, t_len, 1, dtype=torch.float64)
    y = torch.randn(2, t_len, 1, dtype=torch.float64)
    for mode in ("sequential", "blocked"):
        model = CBFSSM(smoke_config(recog_len=recog_len, backward_mode=mode, adjoint="hand"),
                       device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        leaves = [t.requires_grad_(True) for t in params.tensors()]
        loss, _ = model.loss(params.with_tensors(leaves), u, y, torch.Generator().manual_seed(1),
                             condition=False)
        loss.backward()
    cpu = torch.device("cpu")
    resample, write0 = segmentation.backward_masks(t_len, recog_len)
    t_ext, _, shifts = segmentation.blocked_layout(t_len, recog_len)
    zmask = np.arange(t_ext)[None, :] == np.asarray([t_len - 1 + s for s in shifts])[:, None]
    cond = tuple(bool(c) for c in segmentation.forward_condition_mask(t_len, recog_len))
    two_l = 2 * recog_len
    res = tuple(i == 0 for i in range(two_l))
    want = {("cbfssm.resample", t_len, recog_len): resample,
            ("cbfssm.zmask", t_len, recog_len): zmask,
            ("cbfssm.write0", t_len, recog_len): write0,
            ("adjoint.cond", cond): np.asarray(cond),
            ("adjoint.res", res): np.asarray(res)}
    for key, array in want.items():
        got = transfer._CONSTANTS[(key, cpu, None)]
        assert got.dtype == torch.bool and torch.equal(got, torch.as_tensor(array)), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_quaternion_unchanged(dtype):
    """``conjugate`` multiplies by a shared constant equal to the tensor
    it built at each call; it and ``rotate_vector`` give bitwise the old
    numbers."""
    gen = torch.Generator().manual_seed(3)
    q = quaternion.normalize(torch.randn(5, 7, 4, generator=gen, dtype=dtype))
    v = torch.randn(5, 7, 3, generator=gen, dtype=dtype)
    old_sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype)
    assert torch.equal(quaternion.conjugate(q), q * old_sign)
    old_rotate = quaternion.multiply(quaternion.multiply(q, quaternion.from_vector(v)),
                                     q * old_sign)[..., 1:]
    assert torch.equal(quaternion.rotate_vector(v, q), old_rotate)
    sign = transfer._CONSTANTS[("quaternion.conjugate", torch.device("cpu"), dtype)]
    assert sign.dtype == dtype and torch.equal(sign, old_sign)


def test_constant_made_once_anew_under_fake_tensors_and_never_inference():
    made = []

    def make():
        made.append(1)
        return np.arange(3)

    a = transfer.constant(("test.arange", 3), make, "cpu", torch.float32)
    b = transfer.constant(("test.arange", 3), make, "cpu", torch.float32)
    assert a is b and len(made) == 1 and torch.equal(a, torch.arange(3.0))
    c = transfer.constant(("test.arange", 3), make, "cpu", torch.float64)
    assert c.dtype == torch.float64 and len(made) == 2
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    with FakeTensorMode():
        fake = transfer.constant(("test.arange", 3), make, "cpu", torch.float32)
    assert isinstance(fake, FakeTensor) and len(made) == 3
    assert transfer.constant(("test.arange", 3), make, "cpu", torch.float32) is a
    with torch.inference_mode():  # e.g. a served predict first: autograd may save it later
        first = transfer.constant(("test.arange", 3), make, "cpu", torch.float16)
    assert not first.is_inference() and len(made) == 4


# --- static inputs ------------------------------------------------------------------


@pytest.mark.parametrize("kind,t_len", [("cbfssm_pallas", 12), ("cbfssm_pallas", 30),
                                        ("prssm", 12), ("voliro", 6)])
def test_draws_into_buffers_are_the_draws(kind, t_len):
    """``draw_noise(out=)`` draws the numbers ``draw_noise`` draws (both
    CBFSSM schedules: T 12 sequential, T 30 blocked), and a
    ``StaticBatch`` stages them from the generator, or copies ready-made
    draws, with the batch."""
    model = MODELS[kind]("cpu")
    b = 3
    want = model.draw_noise(torch.Generator().manual_seed(7), t_len, b)
    buffers = model.draw_noise(torch.Generator().manual_seed(0), t_len, b)
    got = model.draw_noise(torch.Generator().manual_seed(7), t_len, b, out=buffers)
    for g, w, buf in zip(noise_tensors(got), noise_tensors(want), noise_tensors(buffers),
                         strict=True):
        assert g is buf and torch.equal(g, w)
    u = torch.randn(b, t_len, model.dim_u, dtype=model.dtype)
    y = torch.randn(b, t_len, model.config.dim_y, dtype=model.dtype)
    w = torch.ones(b, dtype=model.dtype)
    static = step_graph.StaticBatch(model, u, y, w)
    static.stage(model, u, y, w, torch.Generator().manual_seed(7), None)
    assert all(torch.equal(a, c) for a, c in ((static.u, u), (static.y, y), (static.w, w)))
    assert all(torch.equal(g, w) for g, w in zip(noise_tensors(static.noise),
                                                   noise_tensors(want)))
    ready = model.draw_noise(torch.Generator().manual_seed(9), t_len, b)
    static.stage(model, u, y, w, None, ready)
    assert all(torch.equal(g, w) for g, w in zip(noise_tensors(static.noise),
                                                   noise_tensors(ready)))


# --- eligibility, counters and spans ------------------------------------------------


def test_eligibility_rule():
    assert step_graph.eligible("cuda", None, False)
    assert step_graph.eligible(torch.device("cuda:1"), None, False)
    assert not step_graph.eligible("cpu", None, False)
    assert not step_graph.eligible("cuda", object(), False)  # a mesh
    assert not step_graph.eligible("cuda", None, True)  # a ParticleParallel model


@pytest.mark.parametrize("epd", [1, 2])
def test_cpu_trainer_runs_eagerly_and_counts(tmp_path, ds, epd):
    """On the CPU every train step and test batch runs eagerly, counted
    in ``eager_steps``; the four counts are in the ``done`` event."""
    metrics = str(tmp_path / "metrics.jsonl")
    tr = Trainer(CBFSSM(smoke_config(), device="cpu"), str(tmp_path / "m"), seed=1,
                 metrics_path=metrics, epochs_per_dispatch=epd)
    assert not tr._graph_on
    epochs = 2
    tr.train(ds, epochs)
    steps = epochs * (-(-len(ds.train_in_batch) // 8) + -(-len(ds.test_in_batch) // 8))
    counts = {"graph_captures": 0, "graph_replays": 0, "eager_steps": steps,
              "graph_fallbacks": 0}
    assert tr.graph_counts() == counts
    with open(metrics) as f:
        done = [e for e in map(json.loads, f) if e["event"] == "done"]
    assert len(done) == 1 and {k: done[0][k] for k in counts} == counts


def test_capture_and_replay_spans_have_phases():
    assert SPAN_PHASES["step.capture"] == "capture"
    assert SPAN_PHASES["step.replay"] == "replay"


def tensors_of(tr):
    """The Trainer's leaves and Adam state tensors."""
    return tr.params.tensors() + [t for p in tr.params.tensors()
                                  for t in tr.optimizer.state[p].values()]


@pytest.mark.parametrize("then", ["retrain", "restore", "init_state"])
def test_leaves_and_adam_state_live_as_long_as_the_trainer(tmp_path, ds, then):
    """After a ``train()`` the Trainer's tensors are written in place by
    a retrain, a ``restore()`` or a fresh ``init_state()``, to bitwise the
    numbers a new Trainer holds after the same call (Adam's state at step
    0 with zero moments before the first step)."""
    def make(path):
        return Trainer(CBFSSM(smoke_config(), device="cpu"), path, seed=2,
                       epochs_per_dispatch=1)

    path = str(tmp_path / "m")
    tr = make(path)
    tr.init_state()
    assert all(not t.any() for p in tr.params.tensors() for t in tr.optimizer.state[p].values())
    tr.train(ds, 2)
    tr.saver.flush(path)
    ids = [id(t) for t in tensors_of(tr)]
    if then == "retrain":
        shutil.copytree(path, str(tmp_path / "copy"))
        fresh = make(str(tmp_path / "copy"))
        fresh._rng = copy.deepcopy(tr._rng)  # the same shuffles
        tr.train(ds, 1, retrain=True)
        fresh.train(ds, 1, retrain=True)
        assert tr.train_all[-1] == fresh.train_all[-1]
    elif then == "restore":
        tr.restore(checkpoint.BEST)
        fresh = make(path)
        fresh.restore(checkpoint.BEST)
    else:
        tr.init_state()
        fresh = make(str(tmp_path / "fresh"))
        fresh.init_state()
    assert [id(t) for t in tensors_of(tr)] == ids
    assert all(torch.equal(a, b) for a, b in zip(tensors_of(tr), tensors_of(fresh), strict=True))


def test_recording_follows_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    assert not profiling.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
    assert not profiling.recording()


# --- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs and the kernel have no CPU mode")
    return torch.device("cuda")


def trees_equal(a, b):
    fa, spec_a = torch.utils._pytree.tree_flatten(a)
    fb, spec_b = torch.utils._pytree.tree_flatten(b)
    return spec_a == spec_b and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(fa, fb))


def state(tr):
    """The Trainer's leaves and Adam state, on the host."""
    return {"leaves": [t.detach().cpu() for t in tr.params.tensors()],
            "opt": torch.utils._pytree.tree_map(
                lambda t: t.cpu() if torch.is_tensor(t) else t, tr.optimizer.state_dict())}


def counted(call):
    """``call()``'s GP kernel launches on the card (``step_graph.launches``)."""
    before = step_graph.launches()
    call()
    torch.cuda.synchronize()
    return {k: n - before[k] for k, n in step_graph.launches().items()}


def train_both(tmp_path, make, data, epochs, **kwargs):
    """The same Trainer twice, made ineligible and graphed: each run's
    Trainer, directory and GP kernel launches."""
    runs = {}
    for graphed in (False, True):
        path = str(tmp_path / ("graph" if graphed else "eager"))
        tr = make(path)
        tr._graph_on = graphed
        runs[graphed] = (tr, path, counted(lambda: tr.train(data, epochs, **kwargs)))
    return runs[False], runs[True]


def assert_runs_equal(eager, graph, names=(checkpoint.BEST, checkpoint.LAST)):
    (tr_e, dir_e, launches_e), (tr_g, dir_g, launches_g) = eager, graph
    for a, b in ((tr_g.train_all, tr_e.train_all), (tr_g.test_all, tr_e.test_all)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))  # NaN equals NaN
    assert trees_equal(state(tr_g), state(tr_e))
    for name in names:
        assert trees_equal(checkpoint.restore(os.path.join(dir_g, name)),
                           checkpoint.restore(os.path.join(dir_e, name))), name
    assert launches_g == launches_e
    assert tr_g.graph_fallbacks == 0 and tr_g.graph_replays > 0


@pytest.mark.cuda
@pytest.mark.parametrize("epd", [1, 4])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_cuda_graphed_trainer_equals_eager(cuda_device, tmp_path, ds, kind, epd):
    """Five epochs (one block of 4 and a tail at epd 4), a ragged last
    batch: bitwise the eager run; the first train step and test batch
    eager, the second of each captured, every later one a replay."""
    data = data_for(kind, ds)
    eager, graph = train_both(tmp_path, lambda path: Trainer(
        MODELS[kind]("cuda"), path, seed=3, epochs_per_dispatch=epd), data, 5)
    assert_runs_equal(eager, graph)
    tr = graph[0]
    b = int(tr.model.config.batch_size)
    steps = 5 * (-(-len(data.train_in_batch) // b) + -(-len(data.test_in_batch) // b))
    assert tr.graph_counts() == {"graph_captures": 2, "graph_replays": steps - 2,
                                 "eager_steps": 2, "graph_fallbacks": 0}
    assert eager[0].graph_counts()["eager_steps"] == steps


@pytest.mark.cuda
def test_cuda_graph_guard_skips_a_nonfinite_batch(cuda_device, tmp_path, ds):
    """A NaN draw from ``noise_fn`` in a replayed step (epoch 2's second
    batch; every other batch draws from its generator): the guard skips
    it in both runs alike."""
    def noise_fn(epoch, split, i, b, t_len):
        if (epoch, split, i) != (2, 0, 1):
            return None
        noise = MODELS["cbfssm_pallas"]("cuda").draw_noise(
            torch.Generator(device="cuda").manual_seed(0), t_len, b)
        noise.forward_eps.fill_(float("nan"))
        return noise

    eager, graph = train_both(tmp_path, lambda path: Trainer(
        CBFSSM(smoke_config(gp_impl="pallas", skip_nonfinite_updates=True), device="cuda"),
        path, seed=4, noise_fn=noise_fn, epochs_per_dispatch=1), ds, 4)
    assert_runs_equal(eager, graph)
    assert graph[0].skipped_steps == eager[0].skipped_steps == 1


@pytest.mark.cuda
def test_cuda_graph_outlives_retrain_and_restore(cuda_device, tmp_path, ds):
    """``retrain=True`` loads the checkpoint into the Trainer's own
    tensors: every step of it replays the graphs the first ``train()``
    captured, and the run equals the eager one's; after ``restore()`` a
    train step is a replay too, with the eager Trainer's loss."""
    def make(path):
        return Trainer(MODELS["cbfssm_pallas"]("cuda"), path, seed=5, epochs_per_dispatch=1)

    first = train_both(tmp_path, make, ds, 2)
    again = [(tr, path, counted(lambda tr=tr: tr.train(ds, 2, retrain=True)))
             for tr, path, _ in first]
    assert_runs_equal(*again)
    tr = again[1][0]
    per_epoch = -(-len(ds.train_in_batch) // 8) + -(-len(ds.test_in_batch) // 8)
    assert tr.graph_counts() == {"graph_captures": 2, "graph_replays": 4 * per_epoch - 2,
                                 "eager_steps": 2, "graph_fallbacks": 0}
    losses = []
    for tr, _, _ in again:
        tr.restore(checkpoint.BEST)
        batch = next(tr._batches(*tr._stage("train", ds.train_in_batch, ds.train_out_batch),
                                 8, True, 9, 0))
        losses.append(tr.train_step(*batch)[0])
    assert tr.graph_counts()["graph_captures"] == 2
    assert tr.graph_counts()["graph_replays"] == 4 * per_epoch - 1
    assert torch.isfinite(losses[1]) and torch.equal(losses[0], losses[1])


@pytest.mark.cuda
def test_cuda_trace_after_capture_sees_the_replayed_kernels(cuda_device, tmp_path, ds):
    """A CUDA-only profiler trace (the benchmark's kind) started after the
    capture and settled before its stop (``profiling.settle``) records
    each kernel of a replayed epoch: as many as an eager epoch's, and the
    replay's own copies; its GP kernels are the launches the card ran by
    ``step_graph.launches``, the replays' by what each graph's capture
    recorded. (A graph instantiated before the process's first trace runs
    its device-to-device copies as the ``memcpy*`` kernels of CUDA's
    own, which the eager step runs as ``Memcpy`` rows; they are not
    counted here.)"""
    from benchmark import tracing

    def kernels(tr, epoch):
        trace = tracing.Trace()
        trace.start()
        ran = counted(lambda: tr._train_epoch(ds, 8, epoch))
        profiling.settle()
        summary = trace.stop()
        by_name = summary["device_ops_by_name"]
        copies = sum(n for name, (n, _) in by_name.items() if name.startswith("memcpy"))
        gp = sum(n for name, (n, _) in by_name.items() if "gp_predict_kernel<" in name)
        assert gp == sum(ran.values()) > 0
        return summary["kernels"] - copies

    kernel_counts = {}
    for graphed in (False, True):
        tr = Trainer(MODELS["cbfssm_pallas"]("cuda"), str(tmp_path / str(graphed)), seed=6,
                     epochs_per_dispatch=1)
        tr._graph_on = graphed
        tr.train(ds, 2)
        kernel_counts[graphed] = kernels(tr, 2)
        assert tr.graph_fallbacks == 0
    steps = -(-len(ds.train_in_batch) // 8)
    # a replayed step adds its copy of w and the copies of loss and applied
    assert 0 < kernel_counts[False] <= kernel_counts[True] <= kernel_counts[False] + 3 * steps
