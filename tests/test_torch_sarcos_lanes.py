"""The lane program (``MultiSeedTrainer``) on CBF-SSM at the Sarcos dims
(dim_x 14, dim_u 7, dim_y 7) against the benchmark's plain reference,
on the CPU in float64 with one torch thread, at small widths (M 8, S 3,
B 2, seq 40, recog_len 4, 3 lanes):

- a lane-batched train step fed weights (``init_params``) and draws
  (``noise_fn``): each lane's loss and gradient (rtol 1e-9) and its
  Adam step's change against the reference followed lane by lane;
- the reference's Sarcos data layer against the port's ``Sarcos`` on a
  file written by the reference;
- the reference's lane rules (shuffles and draws) against the port's;
- the spans and counters of a recorded lane run: the Trainer's span
  names, phases that sum to the run's time, ``counts()`` in
  ``metrics.jsonl``'s ``done`` event.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import harness, spans
from benchmark.mixes import lanes
from benchmark.reference import common
from benchmark.reference import lanes as lane_rules
from benchmark.reference import sarcos
from cbfssm_tpu_torch.data import Sarcos
from cbfssm_tpu_torch.training.multiseed import lane_batch_seed
from cbfssm_tpu_torch.training.trainer import SPAN_PHASES
from cbfssm_tpu_torch.utils.profiling import record_spans

SEED = 2 ** 31 + 2026
SMALL = {"model": {"batch_size": 2, "samples": 3, "ind_pnt_num": 8, "recog_len": 4,
                   "dtype": "float64"},
         "data": {"seq_len": 40, "seq_stride": 500, "train_windows": 12, "test_windows": 4},
         "reproduction": {"iterations": 3}, "gp_predict": {"l": 3}}
TRAINER_SPANS = {"trainer.train", "trainer.epoch", "data.epoch", "data.batch", "step",
                 "step.forward", "step.backward", "step.optimizer", "eval.loss",
                 "trainer.readback", "trainer.log", "trainer.checkpoint"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module, as ``test_torch_lanes``: the
    lane-batched tensors cross torch's parallel grain, and a run of 6
    worker processes oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_run():
    run = lanes.Run(harness.Cell("sarcos-lanes", overrides=SMALL), SEED, "cpu")
    run.make_inputs()
    yield run
    run.close()


def test_train_step_follows_the_reference_lane_by_lane(small_run):
    run = small_run
    run.build()
    tr = run.trainer
    tr.init_state()
    lanes_n, batch = run.n_lanes, int(run.cfg["model"]["batch_size"])
    u_all, y_all = run.windows["train"]
    rows = np.stack([np.random.default_rng([SEED, lane]).choice(len(u_all), batch, replace=False)
                     for lane in range(lanes_n)])
    w = np.ones((lanes_n, batch))
    w[1, -1] = 0.0  # a padded row in one lane
    noise = run.check_noise[0]
    p0 = [t.detach().clone() for t in tr.params.tensors()]
    losses, applied = tr.train_step(torch.as_tensor(u_all[rows]), torch.as_tensor(y_all[rows]),
                                    torch.as_tensor(w),
                                    [run.noise_cls(*noise[lane]) for lane in range(lanes_n)])
    assert bool(applied.all()) and tr.counts()["lane_steps"] == lanes_n
    grads = [p.grad for p in tr.params.tensors()]
    after = [p.detach() for p in tr.params.tensors()]
    lr = float(run.cfg["model"]["learning_rate"])
    for lane in range(lanes_n):
        batches = [(u_all[rows[lane]], y_all[rows[lane]], w[lane], noise[lane])]

        def loss_fn(leaves, u, y, wl, n, p):
            return run.ref.loss(run.cfg, leaves, u, y, wl, n, p)

        ref_losses, ref_grad, ref_last = common.follow(loss_fn, run.leaves[lane], batches, lr,
                                                       common.Precision(torch.float64))
        assert float(losses[lane]) == pytest.approx(ref_losses[0], rel=1e-9)
        # atol: a small share of the median leaf's largest entry, as the
        # benchmark's compare weighs leaves. The inducing inputs' and
        # length scales' gradients are sums of terms near 1 whose order the
        # lane-batched products change (float64 rounding ~4e-15), while the
        # recognition GP's own are ~1e-8 (21 inputs, kernels far below 1);
        # Adam's first step g / (|g| + 1e-8) carries that to ~4e-7 of lr
        grad_tol = 1e-12 * float(np.median([float(g.abs().max()) for g in ref_grad]))
        for name, g, rg, a, b, rl, r0 in zip(run.ref.LEAVES, grads, ref_grad, after, p0,
                                             ref_last, run.leaves[lane]):
            torch.testing.assert_close(g[lane], rg, rtol=1e-9, atol=grad_tol,
                                       msg=lambda m, n=name: f"{n}: {m}")
            torch.testing.assert_close(a[lane] - b[lane], rl - r0, rtol=1e-9, atol=1e-6 * lr,
                                       msg=lambda m, n=name: f"{n}: {m}")


def test_windows_are_the_ports_sarcos(tmp_path):
    cfg = harness.Cell("sarcos-lanes").cfg
    raw = sarcos.make_raw(cfg, SEED)
    assert raw["sarcos_inv"].shape == (66 * 674, 28)
    sarcos.write_raw(cfg, raw, str(tmp_path))
    ds = Sarcos(int(cfg["data"]["seq_len"]), int(cfg["data"]["seq_stride"]),
                data_dir=str(tmp_path))
    ref = sarcos.windows(cfg, raw)
    assert ref["train"][0].shape == (600, 250, 7) and ref["test"][0].shape == (60, 250, 7)
    for split, (u, y) in ref.items():
        np.testing.assert_allclose(u, getattr(ds, f"{split}_in_batch"), rtol=0, atol=1e-12)
        np.testing.assert_allclose(y, getattr(ds, f"{split}_out_batch"), rtol=0, atol=1e-12)
    cut = lanes.cut(cfg, ref)
    assert cut["train"][0].shape[0] == 100 and cut["test"][0].shape[0] == 10
    np.testing.assert_array_equal(cut["train"][0], ref["train"][0][:100])


def test_lane_rules_are_the_ports(small_run):
    run = small_run
    run.build()
    tr = run.trainer
    batch, n = int(run.cfg["model"]["batch_size"]), 7
    want = lane_rules.first_lane_batches(run.seed, n, batch, 8, run.n_lanes)
    got = [[] for _ in range(run.n_lanes)]
    while len(got[0]) < 8:
        idx, w = tr._epoch_indices(n, batch, True)
        for lane in range(run.n_lanes):
            got[lane].extend(zip(idx[lane], w[lane]))
    for lane in range(run.n_lanes):
        for (i, w), (gi, gw) in zip(want[lane], got[lane]):
            np.testing.assert_array_equal(i, gi)
            np.testing.assert_array_equal(w, gw)
    for epoch, split, lane, i in ((0, 0, 2, 1), (3, 1, 0, 0)):
        assert lane_rules.lane_seed(run.seed, epoch, split, lane, i) == lane_batch_seed(
            run.seed, epoch, split, lane, i)
        gen = torch.Generator().manual_seed(lane_batch_seed(run.seed, epoch, split, lane, i))
        port = run.model.draw_noise(gen, run.t_len, batch)
        ref = lane_rules.lane_draws(run.shapes, run.seed, epoch, split, lane, i, torch.float64,
                                    "cpu")
        for a, b in zip((port.backward_noise, port.backward_eps, port.forward_eps), ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("epd", [1, 2])
def test_a_recorded_lane_run_has_the_trainers_spans_and_counts(small_run, tmp_path, epd):
    run = small_run
    run.build()
    from cbfssm_tpu_torch.training import MultiSeedTrainer

    path = tmp_path / "metrics.jsonl"
    tr = MultiSeedTrainer(run.model, str(tmp_path / "model"), n_seeds=run.n_lanes, seed=3,
                          metrics_path=str(path), epochs_per_dispatch=epd)
    with record_spans() as recorded:
        tr.train(run.ds, 2)
    names = {s[0] for s in recorded}
    assert TRAINER_SPANS <= names and names <= set(SPAN_PHASES)
    if epd > 1:
        assert "trainer.block" in names
    top = [s for s in recorded if s[1] is None]
    assert [s[0] for s in top] == ["trainer.train"]
    whole = [(top[0][2], top[0][3])]
    by_phase = spans.host_ns_by_phase(recorded, SPAN_PHASES, whole)
    assert sum(by_phase.values()) == top[0][3] - top[0][2]
    steps = 2 * -(-run.ds.train_in_batch.shape[0] // int(run.cfg["model"]["batch_size"]))
    assert spans.count_in(recorded, "step", whole) == steps
    assert spans.count_in(recorded, "eval.loss", whole) == 2 * 2
    done = [json.loads(line) for line in path.read_text().splitlines()][-1]
    assert done["event"] == "done"
    want = {"train_steps": steps, "lane_steps": steps * run.n_lanes, "skipped_lane_steps": 0,
            "residual_lane_launches": 0, "value_lane_launches": 0}  # the CPU launches none
    assert {k: done[k] for k in want} == want == tr.counts()
