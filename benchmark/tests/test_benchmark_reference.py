"""The plain reference against the port, at small sizes on the CPU: data
layer, loss, gradient and Adam's first steps, in float64 (where both
must agree to rounding) and in float32 (the cell's type), and the
control (the reference in TF32) failing the committed limits."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.mixes import train
from benchmark.reference import common

ROOT = Path(__file__).resolve().parents[2]
SMALL = {
    "robomove-train": {"model": {"batch_size": 4, "samples": 3, "ind_pnt_num": 6,
                                 "recog_len": 5},
                       "data": {"seq_len": 30, "seq_stride": 500}},
    "voliro-train": {"model": {"batch_size": 4, "samples": 3, "ind_pnt_num": 6}},
}
CELLS = sorted(SMALL)


def program_model(run, dtype):
    """The port's model at ``dtype`` on the CPU, with the run's dataset."""
    run.cfg["model"]["dtype"] = dtype
    run.build()
    return run.model


@pytest.fixture(scope="module", params=CELLS)
def small_run(request):
    run = train.Run(harness.Cell(request.param, overrides=SMALL[request.param]), 987654321,
                      "cpu")
    run.make_inputs()
    yield run
    run.close()


def test_windows_are_the_data_layers(small_run):
    run = small_run
    ds = program_model(run, "float32") and run.ds
    for split, (u, y) in run.windows.items():
        # the same numbers up to the order of the mean's sums
        np.testing.assert_allclose(u, getattr(ds, f"{split}_in_batch"), rtol=0, atol=1e-12)
        np.testing.assert_allclose(y, getattr(ds, f"{split}_out_batch"), rtol=0, atol=1e-12)


def test_first_batches_follow_the_trainers_shuffle(small_run):
    from cbfssm_tpu_torch.training.trainer import epoch_indices

    rng = np.random.default_rng(small_run.seed)
    n, batch = small_run.windows["train"][0].shape[0], 4
    want = []
    while len(want) < 5:
        idx, w = epoch_indices(rng, n, batch, True, np.float64)
        want.extend(zip(idx, w))
    for (i, w), (wi, ww) in zip(common.first_batches(small_run.seed, n, batch, 5), want):
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_array_equal(w, ww)


def test_trainer_draws_are_the_ports(small_run):
    """The last checked step's draws, worked out again by the trainer's
    rule, equal those the port's trainer makes for that batch."""
    from cbfssm_tpu_torch.training.trainer import batch_seed

    run = small_run
    model = program_model(run, "float32")
    batch, (epoch, i) = int(run.cfg["model"]["batch_size"]), run.drawn_at
    gen = torch.Generator().manual_seed(batch_seed(run.seed, epoch, 0, i))
    port = model.draw_noise(gen, run.t_len, batch)
    ref = common.trainer_draws(run.shapes, run.seed, epoch, 0, i, torch.float32, "cpu")
    port = [getattr(port, f.name) for f in dataclasses.fields(port)]
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loss_and_gradient_equal_the_ports_in_float64(small_run):
    run = small_run
    model = program_model(run, "float64")
    leaves = [t.double() for t in run.leaves]
    u, y = (torch.as_tensor(a[:4]) for a in run.windows["train"])
    w = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64)
    noise = [n.double() for n in run.check_noise[0]]
    port_leaves = [t.clone().requires_grad_(True) for t in leaves]
    params = model.init(torch.Generator().manual_seed(0)).with_tensors(port_leaves)
    port_loss, _ = model.loss(params, u, y, None, True, w, run.noise_cls(*noise))
    port_grad = torch.autograd.grad(port_loss, port_leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in leaves]
    ref_loss = run.ref.loss(run.cfg, ref_leaves, u, y, w, noise, common.Precision())
    ref_grad = torch.autograd.grad(ref_loss, ref_leaves)
    assert float(ref_loss.detach()) == pytest.approx(float(port_loss.detach()), rel=1e-11)
    for name, a, b in zip(run.ref.LEAVES, port_grad, ref_grad):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10 * float(b.abs().max()),
                                   msg=name)


def test_follow_tracks_the_trainers_first_steps(small_run):
    """The cell's readings in float32 on the CPU: the trainer's first
    steps against the float64 reference stay far inside the limits."""
    run = small_run
    run.cfg["model"]["dtype"] = "float32"
    program = run.setup(steps_only=True)
    run.free_program()
    gaps = train.compare(program, run.reference(common.Precision(torch.float64)))
    assert max(gaps.values()) < 1e-3, gaps


def test_control_fails_the_limits():
    """The control, the reference in TF32 in the program's place, is not
    correct under the committed limits (RoboMove's first steps at the
    cell's widths, two time windows shorter)."""
    over = {"data": {"seq_len": 100, "seq_stride": 5000}, "model": {"batch_size": 8}}
    cell = harness.Cell("robomove-train", overrides=over)
    run = train.Run(cell, 20251018, "cpu")
    run.make_inputs()
    ref = run.reference(common.Precision(torch.float64))
    ctl = run.reference(common.Precision(torch.float32, tf32=True))
    run.close()
    check = harness.checks(train.compare(ctl, ref), cell.cfg["limits"])
    assert not harness.passed(check), check


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-5],
                     dtype=torch.float32)
    got = common.tf32_round(x)
    assert got[:4].tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10]
    assert abs(float(got[4]) / -3.0e-5 - 1.0) < 2 ** -11


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.common, benchmark.reference.cbfssm, "
            "benchmark.reference.voliro, benchmark.yardstick\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd="/")
    top = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not top & {"cbfssm_tpu_torch", "cbfssm_tpu", "jax", "jaxlib", "flax"}
