"""The lane-batched form of the fused GP predict and of the models, on
the CPU in float64 (the ``cuda`` cases run on a GPU).

- ``FusedPredict`` under ``torch.func.vmap`` against a loop over the
  lanes (rtol 1e-12): values and every gradient, batched and unbatched
  x, one lane, no rows, and inference mode.
- The port's vmapped model loss against
  ``jax.vmap(jax.value_and_grad(model.loss, has_aux=True))`` on a
  stacked ``jax.vmap(model.init)`` and the JAX key schedule's noise per
  lane (loss and aux rtol 1e-7, gradients 1e-6), for CBFSSM, CBFSSMHALF
  ('rnn') and PRSSM ('rnn').
- Loss-time hyperparameters as tensors equal the float path (rtol
  1e-12) and JAX's ``SweptModel`` at the same value; the written-out GRU
  step equals ``nn.GRUCell`` (rtol 1e-12).
- ``cuda``: the lane kernels against their plain versions, L = 1
  against the single-lane entry points, and the inducing-point cap per
  lane.

The JAX package is imported inside the tests that compare with it, so
that on a GPU machine whose JAX lacks flax

    python -m pytest --noconftest tests/test_torch_lanes.py

runs the ``cuda`` cases (the JAX comparisons skip there).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import vmap

from cbfssm_tpu_torch import convert
from cbfssm_tpu_torch.models import CBFSSM, CBFSSMHALF, PRSSM, recognition
from cbfssm_tpu_torch.ops import fused_predict as fp
from cbfssm_tpu_torch.training.multiseed import noise_like, stack_noise
from cbfssm_tpu_torch.utils.kernel_timing import MODEL_SHAPES, kernel_inputs

NAMES = ("x", "zs", "inv_ls", "kvar", "kinv", "alpha", "var_q")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module. The lane-batched tensors cross
    torch's parallel grain, and in a test run of 6 worker processes on an
    8-core CPU the oversubscribed threads made a multi-seed driver case
    20-30x slower than with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lane_inputs(lanes, n=9, m=6, di=3, d=2, seed=0, device="cpu", dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [kernel_inputs(rng, n, m, di, d, dtype, device) for _ in range(lanes)]


def stacked(lanes_args):
    return [torch.stack(ts) for ts in zip(*lanes_args)]


def objective(mean, var):
    return torch.sum(torch.sin(mean)) + torch.sum(var * var)


@pytest.mark.parametrize("lanes,n,x_batched", [(3, 9, True), (3, 9, False), (1, 9, True),
                                               (2, 0, True)])
def test_vmapped_function_matches_lane_loop(lanes, n, x_batched):
    args = lane_inputs(lanes, n=n)
    if not x_batched:
        args = [(args[0][0], *a[1:]) for a in args]
    leaves = [t.clone().requires_grad_(True) for t in stacked(args)]
    in_dims = (0 if x_batched else None,) + (0,) * 6
    if not x_batched:
        leaves[0] = args[0][0].clone().requires_grad_(True)

    def one(*a):
        return objective(*fp.fused_predict(*a))

    got = vmap(one, in_dims=in_dims)(*leaves)
    got.sum().backward()
    grad_x = torch.zeros_like(leaves[0])
    for lane in range(lanes):
        single = [t.clone().requires_grad_(True) for t in args[lane]]
        want = objective(*fp.fused_predict_plain(*single))
        np.testing.assert_allclose(float(got[lane].detach()), float(want.detach()), rtol=1e-12)
        grads = torch.autograd.grad(want, single, allow_unused=True)
        for k, (leaf, g) in enumerate(zip(leaves, grads)):
            g = torch.zeros_like(single[k]) if g is None else g
            if k == 0 and not x_batched:
                grad_x += g
                continue
            torch.testing.assert_close(leaf.grad[lane], g, rtol=1e-12, atol=1e-14,
                                       msg=NAMES[k])
    if not x_batched:  # the shared x sums the lanes' gradients
        torch.testing.assert_close(leaves[0].grad, grad_x, rtol=1e-12, atol=1e-14)
    # no grad: the value path under vmap gives the same numbers
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            again = vmap(one, in_dims=in_dims)(*leaves)
        torch.testing.assert_close(again, got.detach(), rtol=0, atol=0)


def test_lane_wrappers_equal_single_calls_and_check_shapes(monkeypatch):
    args = lane_inputs(3, seed=1)
    monkeypatch.setattr(fp.fused_predict, "lane_launches", 0)
    mean, var = fp.fused_predict_lanes(*stacked(args))
    res = fp.fused_predict_residuals_lanes(*stacked(args))
    for lane, a in enumerate(args):
        want = fp.fused_predict_residuals(*a)
        for g, w in zip((mean, var), want[:2]):
            torch.testing.assert_close(g[lane], w, rtol=1e-12, atol=0)
        for g, w in zip(res, want):
            torch.testing.assert_close(g[lane], w, rtol=1e-12, atol=0)
    assert fp.fused_predict.lane_launches == 0  # the CPU launches nothing
    bad = stacked(args)
    bad[3] = bad[3][:2]  # kvar [2] against 3 lanes
    with pytest.raises(ValueError, match="kvar"):
        fp.fused_predict_lanes(*bad)
    with pytest.raises(ValueError, match=r"\[L, N, DI\]"):
        fp.fused_predict_lanes(*args[0])
    empty = [t[:0] for t in stacked(args)]
    assert [tuple(t.shape) for t in fp.fused_predict_residuals_lanes(*empty)] == [
        (0, 9, 2), (0, 9, 2), (0, 9, 6), (0, 9, 6)]


def test_value_path_takes_the_function_only_when_batched(monkeypatch):
    """Plain tensors go straight to the kernel wrapper, without the
    Function's dispatch (host time on every serving call); a batched
    operand goes through ``FusedPredictValue``, whose vmap rule runs the
    value lane kernel."""
    calls = []
    apply = fp.FusedPredictValue.apply
    monkeypatch.setattr(fp.FusedPredictValue, "apply", lambda *a: calls.append(1) or apply(*a))
    args = lane_inputs(3, seed=2)
    with torch.no_grad():
        single = fp.fused_predict(*args[0])
        assert calls == []
        mean, var = vmap(fp.fused_predict)(*stacked(args))
    assert len(calls) == 1
    for g, w in zip(single, fp.fused_predict_plain(*args[0])):
        assert torch.equal(g, w)
    for lane, a in enumerate(args):
        want_mean, want_var = fp.fused_predict_plain(*a)
        torch.testing.assert_close(mean[lane], want_mean, rtol=1e-12, atol=0)
        torch.testing.assert_close(var[lane], want_var, rtol=1e-12, atol=0)


# --- the models against jax.vmap(jax.value_and_grad(loss)) ------------------

def jax_setup(name):
    """(jax model, port model, from_numpy, to_numpy, params_numpy,
    noise(port model, key)) of one model; skips where the JAX package
    cannot be imported."""
    pytest.importorskip("flax")
    from cbfssm_tpu.models import CBFSSMHALF as JaxCBFSSMHALF
    from cbfssm_tpu.models import PRSSM as JaxPRSSM
    from tests.test_cbfssm_model import make_model
    from tests.test_other_models import half_config, prssm_config
    from tests.test_torch_cbfssm import jax_noise, port_config
    from tests.test_torch_cbfssm import params_numpy as cbfssm_numpy
    from tests.test_torch_other_models import jax_eps
    from tests.test_torch_other_models import params_numpy as recog_numpy

    if name == "cbfssm":
        jm = make_model(backward_mode="blocked")
        return (jm, CBFSSM(port_config(jm), device="cpu"), convert.cbfssm_params_from_numpy,
                convert.cbfssm_params_to_numpy, cbfssm_numpy,
                lambda pm, key: jax_noise(pm, key, 8, 2))
    jax_cls, port_cls, cfg = {"half": (JaxCBFSSMHALF, CBFSSMHALF, half_config("rnn")),
                              "prssm": (JaxPRSSM, PRSSM, prssm_config("rnn"))}[name]
    from_numpy = {"half": convert.cbfssmhalf_params_from_numpy,
                  "prssm": convert.prssm_params_from_numpy}[name]
    jm = jax_cls(cfg)
    cfg = {f.name: getattr(jm.config, f.name) for f in dataclasses.fields(jm.config)
           if f.name != "extra"}
    return (jm, port_cls(cfg, device="cpu"), from_numpy, convert.cbfssmhalf_params_to_numpy,
            recog_numpy, lambda pm, key: jax_eps(key, 8, 2, pm.samples))


@pytest.mark.parametrize("name", ["cbfssm", "half", "prssm"])
def test_vmapped_loss_and_grads_match_jax(name):
    jm, pm, from_numpy, to_numpy, params_numpy, noise = jax_setup(name)
    import jax
    lanes = 3
    params = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(0), lanes))
    keys = jax.random.split(jax.random.PRNGKey(5), lanes)
    rng = np.random.default_rng(4)
    u, y = rng.normal(size=(2, 8, 2)), rng.normal(size=(2, 8, 1))
    (want, want_aux), want_g = jax.jit(jax.vmap(
        jax.value_and_grad(lambda p, k: jm.loss(p, u, y, k, True), has_aux=True)))(params, keys)

    tparams = from_numpy(params_numpy(params), device="cpu")
    leaves = [t.clone().requires_grad_(True) for t in tparams.tensors()]
    noises = [noise(pm, keys[lane]) for lane in range(lanes)]

    def one(lv, nts):
        return pm.loss(tparams.with_tensors(lv), u, y, noise=noise_like(noises[0], nts))

    got, got_aux = vmap(one)(leaves, stack_noise(noises))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-7)
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k].detach().numpy(), np.asarray(want_aux[k]),
                                   rtol=1e-7, atol=1e-12, err_msg=k)
    got_g = jax.tree_util.tree_leaves_with_path(
        to_numpy(tparams.with_tensors([t.grad for t in leaves])))
    want_g = dict(jax.tree_util.tree_leaves_with_path(params_numpy(want_g)))
    assert len(got_g) == len(want_g)
    for path, g in got_g:
        w = want_g[path]
        assert g.shape == w.shape and g.shape[0] == lanes
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-10 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    # one lane of the stacked conversion is the single conversion of that lane
    single = from_numpy(convert.lane(params_numpy(params), 1), device="cpu")
    for a, b in zip(single.tensors(), tparams.tensors()):
        assert torch.equal(a, b[1])
    back = convert.stack([to_numpy(tparams.with_tensors([t[i] for t in tparams.tensors()]))
                          for i in range(lanes)])
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params_numpy(params))):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


# --- loss-time hyperparameters as tensors -------------------------------------

@pytest.mark.parametrize("field,value", [("k_factor", 35.0), ("loss_factors", [0.4, 0.2])])
def test_tensor_hypers_equal_floats_and_jax_swept_model(field, value):
    jm, _, _, _, cbfssm_params_numpy, _ = jax_setup("cbfssm")
    import jax
    import jax.numpy as jnp

    from cbfssm_tpu.training.sweep import SweptModel as JaxSweptModel
    from tests.test_torch_cbfssm import jax_noise, port_config

    cfg = port_config(jm)
    pm_float = CBFSSM(dict(cfg, **{field: np.asarray(value)}), device="cpu")
    pm_tensor = CBFSSM(dict(cfg, **{field: torch.tensor(value, dtype=torch.float64)}),
                       device="cpu")
    params = jm.init(jax.random.PRNGKey(1))
    tparams = convert.cbfssm_params_from_numpy(cbfssm_params_numpy(params), device="cpu")
    rng = np.random.default_rng(2)
    u, y = rng.normal(size=(2, 8, 2)), rng.normal(size=(2, 8, 1))
    key = jax.random.PRNGKey(9)
    noise = jax_noise(pm_float, key, 8, 2)
    want_float = float(pm_float.loss(tparams, u, y, noise=noise)[0])
    got = float(pm_tensor.loss(tparams, u, y, noise=noise)[0])
    np.testing.assert_allclose(got, want_float, rtol=1e-12)
    swept = JaxSweptModel(type(jm), jm.config, (field,))
    sp = {"model": params, "hyper": {field: jnp.asarray(value, dtype=jnp.float64)}}
    want_jax = float(jax.jit(lambda p: swept.loss(p, u, y, key, True)[0])(sp))
    np.testing.assert_allclose(got, want_jax, rtol=1e-7)


def test_written_out_gru_step_equals_gru_cell():
    module = recognition.GRURecognition(5, 4, torch.float64, device="cpu")
    leaves = recognition.init_leaves(module, torch.Generator().manual_seed(0), torch.float64,
                                     "cpu")
    gen = torch.Generator().manual_seed(1)
    leaves["cell.bias_ih"] = torch.randn(48, generator=gen, dtype=torch.float64)
    leaves["cell.bias_hn"] = torch.randn(16, generator=gen, dtype=torch.float64)
    uy = torch.randn((3, 7, 5), generator=gen, dtype=torch.float64)
    got = recognition.apply(module, leaves, uy)
    named = module.module_tensors(leaves)
    cell = torch.nn.GRUCell(5, 16, dtype=torch.float64)
    cell_params = {k[len("cell."):]: v for k, v in named.items() if k.startswith("cell.")}
    h = torch.zeros((3, 16), dtype=torch.float64)
    for t in range(6, -1, -1):
        h = torch.func.functional_call(cell, cell_params, (uy[:, t], h))
    want = torch.nn.functional.linear(h, named["readout.weight"], named["readout.bias"])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


# --- the lane kernels on the card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


# Sarcos recognition and forward at 5 lanes, RoboMove recognition (64-row
# tiles, 800 blocks) and forward at 4 lanes (the sweep), ragged ones: N
# not a multiple of the row tile (3 x 65 rows: tiles of 4; 2 x 4,225:
# tiles of 36, two full mma row tiles and one of 4 rows), M past an mma
# width, D = 0 and 14
LANE_SHAPES = [(5, *MODEL_SHAPES["sarcos recognition"]), (5, *MODEL_SHAPES["sarcos forward"]),
               (4, 12800, 100, 6, 2), (4, 1600, 100, 6, 4), (3, 37, 11, 5, 3), (2, 1, 1, 1, 1),
               (7, 53, 101, 8, 5), (3, 65, 17, 6, 0), (2, 4225, 105, 5, 14)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-5),
                                             (torch.float64, 1e-10, 1e-12)])
@pytest.mark.parametrize("lanes,n,m,di,d", LANE_SHAPES)
def test_cuda_lane_kernels_match_plain(cuda_device, dtype, rtol, atol, lanes, n, m, di, d):
    args = stacked(lane_inputs(lanes, n, m, di, d, seed=n, device=cuda_device, dtype=dtype))
    value_before = fp.fused_predict.lane_launches
    res_before = fp.fused_predict_residuals.lane_launches
    got = fp.fused_predict_lanes(*args)
    got_res = fp.fused_predict_residuals_lanes(*args)
    torch.cuda.synchronize()
    assert fp.fused_predict.lane_launches == value_before + 1
    assert fp.fused_predict_residuals.lane_launches == res_before + 1
    mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
    for g, want in zip((*got, *got_res), (mean, var, mean, var, kmn, w)):
        torch.testing.assert_close(g, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_one_lane_equals_single_entry(cuda_device, dtype):
    args = lane_inputs(1, 1800, 100, 21, 7, seed=3, device=cuda_device, dtype=dtype)[0]
    single = fp.fused_predict_residuals(*args)
    lanes = fp.fused_predict_residuals_lanes(*(a[None] for a in args))
    for a, b in zip(single, lanes):
        assert torch.equal(a, b[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_inducing_point_cap_per_lane(cuda_device, dtype):
    cap = fp.max_inducing_points(dtype, 6, 4)
    args = stacked(lane_inputs(3, 5, cap, 6, 4, device=cuda_device, dtype=dtype))
    fp.fused_predict_lanes(*args)  # the cap holds per lane: 3 lanes of M = cap fit
    over = stacked(lane_inputs(3, 5, cap + 1, 6, 4, device=cuda_device, dtype=dtype))
    with pytest.raises(ValueError, match="inducing points"):
        fp.fused_predict_lanes(*over)


@pytest.mark.cuda
def test_cuda_vmapped_grads_launch_lane_kernels(cuda_device):
    args = lane_inputs(3, 40, 12, 4, 3, device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in stacked(args)]
    before = (fp.fused_predict.launches, fp.fused_predict_residuals.launches,
              fp.fused_predict_residuals.lane_launches)
    out = vmap(lambda *a: objective(*fp.fused_predict(*a)))(*leaves)
    out.sum().backward()
    assert (fp.fused_predict.launches, fp.fused_predict_residuals.launches,
            fp.fused_predict_residuals.lane_launches) == (before[0], before[1], before[2] + 1)
    for lane in range(3):
        single = [t.clone().requires_grad_(True) for t in args[lane]]
        want = objective(*fp.fused_predict_plain(*single))
        for leaf, g in zip(leaves, torch.autograd.grad(want, single)):
            torch.testing.assert_close(leaf.grad[lane], g, rtol=1e-10, atol=1e-12)
