"""The port's Voliro slice against ``cbfssm_tpu`` (CPU, float64): the
quaternion ops, rotations, ``beta_logpdf``, the flight-log loader and
datasets, the ``Voliro`` model (loss, aux, every gradient leaf, predict,
the streaming entry points), ``OutputsVoliro``, and the batch
predictors' refusal of a model whose predict returns a dict.

Both packages get the same parameters (the JAX pytree through
``cbfssm_tpu_torch.convert``) and the same random numbers: the JAX model
splits its loss key into ``kz, kb, kf`` and draws ``normal(kz, (B, T, S,
1))``, ``normal(kb, (T, B, S, 1))`` and ``normal(kf, (T-1, B, S, 1))``;
the port takes those arrays as ``noise=VoliroNoise(...)``. Tolerances:
arrays rtol 1e-7, gradient leaves rtol 1e-6 with atol 1e-8 times the
largest entry, the streaming entry points rtol 1e-10, numpy host code
byte for byte.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from cbfssm_tpu.data.datasets import VoliroFlipDS as JaxFlipDS
from cbfssm_tpu.data.datasets import VoliroTiltDS as JaxTiltDS
from cbfssm_tpu.data.voliro_loader import VoliroLog as JaxVoliroLog
from cbfssm_tpu.data.voliro_loader import unwrap_euler_angles as jax_unwrap
from cbfssm_tpu.models import Voliro as JaxVoliro
from cbfssm_tpu.ops import distributions as jax_dist
from cbfssm_tpu.ops import quaternion as jax_quat
from cbfssm_tpu.outputs.outputs import Outputs as JaxOutputs
from cbfssm_tpu.utils import rotations as jax_rot
from cbfssm_tpu_torch import convert
from cbfssm_tpu_torch.data import VoliroFlipDS, VoliroTiltDS, synthetic
from cbfssm_tpu_torch.data.voliro_loader import VoliroLog, unwrap_euler_angles
from cbfssm_tpu_torch.models import Voliro
from cbfssm_tpu_torch.models.voliro import VoliroNoise
from cbfssm_tpu_torch.ops import distributions, quaternion
from cbfssm_tpu_torch.outputs import OutputsVoliro
from cbfssm_tpu_torch.serving import BucketedPredictor, CompiledPredictor
from cbfssm_tpu_torch.utils import rotations
from tests.test_other_models import voliro_batch, voliro_config
from tests.test_voliro_dataset import make_log

RTOL = 1e-7
GRAD_RTOL = 1e-6
STREAM_RTOL = 1e-10
B, T = 2, 8


def config(**overrides):
    """tests/test_other_models.py's Voliro config at M 5, S 2."""
    return dict(voliro_config(), ind_pnt_num=5, samples=2, **overrides)


def params_numpy(params):
    """A JAX VoliroParams as the nested numpy dict convert takes."""
    gps = {g: {k: np.asarray(getattr(getattr(params, g), k)) for k in convert.GP_LEAVES}
           for g in ("gp_f", "gp_b")}
    return {**gps, **{k: np.asarray(getattr(params, k)) for k in convert.VOLIRO_NOISE_LEAVES}}


def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape + (1,), dtype=jnp.float64))


def jax_noise(key, b, t_len, s):
    """The draws of the JAX rollout for ``key``."""
    kz, kb, kf = jax.random.split(key, 3)
    return VoliroNoise(*(torch.tensor(normal(k, shape)) for k, shape in (
        (kz, (b, t_len, s)), (kb, (t_len, b, s)), (kf, (t_len - 1, b, s)))))


@pytest.fixture(scope="module")
def setups():
    """(jax model, jax params, port model, port params) per gp_impl."""
    cache = {}

    def get(gp_impl="solve_free", **overrides):
        key = (gp_impl, tuple(sorted(overrides.items())))
        if key not in cache:
            cfg = config(gp_impl=gp_impl, **overrides)
            jm = JaxVoliro(cfg)
            params = jm.init(jax.random.PRNGKey(0))
            pm = Voliro(cfg, device="cpu")
            cache[key] = (jm, params, pm,
                          convert.voliro_params_from_numpy(params_numpy(params), device="cpu"))
        return cache[key]

    return get


# --- quaternions, rotations, beta_logpdf -----------------------------------


@pytest.mark.parametrize("op", ["multiply", "conjugate", "from_vector", "rotate_vector",
                                "normalize"])
def test_quaternion_ops_match_jax(op):
    rng = np.random.default_rng(0)
    a, b, v = rng.normal(size=(3, 5, 4)), rng.normal(size=(3, 5, 4)), rng.normal(size=(3, 5, 3))
    args = {"multiply": (a, b), "conjugate": (a,), "from_vector": (v,),
            "rotate_vector": (v, a / np.linalg.norm(a, axis=-1, keepdims=True)),
            "normalize": (a,)}[op]
    want = np.asarray(getattr(jax_quat, op)(*(jnp.asarray(x) for x in args)))
    got = getattr(quaternion, op)(*(torch.tensor(x) for x in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)


def test_rotations_are_the_jax_arrays():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(7, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rpy = rng.uniform(-1.0, 1.0, size=(3, 7))
    assert np.array_equal(rotations.euler_from_quaternion(q), jax_rot.euler_from_quaternion(q))
    assert np.array_equal(rotations.quaternion_from_euler(*rpy),
                          jax_rot.quaternion_from_euler(*rpy))
    assert np.array_equal(rotations.euler_matrix(*rpy), jax_rot.euler_matrix(*rpy))


@pytest.mark.parametrize("kind", ["scalar", "tensor"])
def test_beta_logpdf_matches_jax(kind):
    x = np.random.default_rng(2).uniform(0.05, 0.95, size=(6,))
    a, b = 10.0, 2.0
    want = np.asarray(jax_dist.beta_logpdf(jnp.asarray(x), a, b))
    if kind == "tensor":
        a, b = torch.tensor(a, dtype=torch.float64), torch.tensor(b, dtype=torch.float64)
    got = distributions.beta_logpdf(torch.tensor(x), a, b).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


# --- flight logs and datasets ----------------------------------------------


@pytest.fixture(scope="module")
def voliro_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("voliro")) + "/"
    make_log(d + "voliro_tilt.mat", n=4000, seed=1)
    make_log(d + "voliro_flip.mat", n=20500, seed=2)
    return d


def test_synthetic_log_is_the_jax_fixture(tmp_path):
    """The port's synthetic flight log is tests/test_voliro_dataset.py's
    make_log, array for array."""
    synthetic.voliro_log(str(tmp_path / "port.mat"), n=300, seed=4)
    make_log(str(tmp_path / "jax.mat"), n=300, seed=4)
    got, want = (scipy.io.loadmat(tmp_path / f)["dataset"] for f in ("port.mat", "jax.mat"))
    assert set(got.dtype.names) == set(want.dtype.names)
    for k in want.dtype.names:
        assert np.array_equal(got[k][0][0], want[k][0][0]), k


def test_unwrap_euler_angles_is_the_jax_filter():
    rng = np.random.default_rng(3)
    series = np.cumsum(rng.normal(scale=1.5, size=(200, 3)), axis=0) % (2 * np.pi) - np.pi
    assert np.array_equal(unwrap_euler_angles(series), jax_unwrap(series))
    assert np.array_equal(unwrap_euler_angles(series[:, 0]), jax_unwrap(series[:, 0]))


def test_voliro_log_is_the_jax_log(voliro_dir):
    got = VoliroLog(voliro_dir + "voliro_tilt.mat", 1500, 3800)
    want = JaxVoliroLog(voliro_dir + "voliro_tilt.mat", 1500, 3800)
    names = [k for k in vars(want) if isinstance(getattr(want, k), np.ndarray)]
    assert set(names) >= {"pos", "wxyz", "linvel", "linacc", "angvel", "angacc", "battery"}
    assert got.dt == want.dt
    for k in names:
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("cls,jax_cls", [(VoliroFlipDS, JaxFlipDS), (VoliroTiltDS, JaxTiltDS)])
def test_voliro_datasets_are_the_jax_arrays(voliro_dir, cls, jax_cls):
    got = cls(64, 50, data_dir=voliro_dir)
    want = jax_cls(64, 50, data_dir=voliro_dir)
    for k in ("train_in", "train_out", "test_in", "test_out", "test_in2", "test_out2",
              "train_in_batch", "train_out_batch", "test_in_batch", "test_out_batch"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    for k in ("in", "out"):
        assert np.array_equal(got.mean[k], want.mean[k]) and np.array_equal(got.std[k],
                                                                             want.std[k])
    assert (got.MASS, got.INERTIA.tolist()) == (Voliro.MASS, list(Voliro.INERTIA))


# --- the model ---------------------------------------------------------------


@pytest.mark.parametrize("gp_impl", ["solve_free", "pallas"])
def test_loss_aux_and_predict_match_jax(setups, gp_impl):
    jm, params, pm, tparams = setups(gp_impl)
    u, y = voliro_batch(np.random.default_rng(4), b=B, t=T)
    key = jax.random.PRNGKey(3)
    noise = jax_noise(key, B, T, pm.samples)
    (want, want_aux), want_p = jax.jit(lambda p: (jm.loss(p, u, y, key),
                                                  jm.predict(p, u, y, key)))(params)
    got, got_aux = pm.loss(tparams, u, y, noise=noise)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert set(got_aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]), rtol=RTOL, atol=1e-12,
                                   err_msg=k)
    got_p = pm.predict(tparams, u, y, noise=noise)
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]), rtol=RTOL,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("gp_impl", ["solve_free", "pallas"])
def test_grads_match_jax(setups, gp_impl):
    """Every leaf of gp_f, gp_b and the three noises against jax.grad;
    under 'pallas' the batched force predict's gradient reaches gp_f's
    lengthscales through FusedPredict and through the Beta prior."""
    jm, params, pm, tparams = setups(gp_impl)
    u, y = voliro_batch(np.random.default_rng(5), b=B, t=T)
    key = jax.random.PRNGKey(4)
    want = params_numpy(jax.jit(jax.grad(lambda p: jm.loss(p, u, y, key)[0]))(params))
    leaves = [t.clone().requires_grad_(True) for t in tparams.tensors()]
    loss, _ = pm.loss(tparams.with_tensors(leaves), u, y, noise=jax_noise(key, B, T, pm.samples))
    got = convert.voliro_params_to_numpy(tparams.with_tensors(torch.autograd.grad(loss, leaves)))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(flat_got) == set(flat_want) and len(flat_want) == 13
    for path, w in flat_want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(flat_got[path], w, rtol=GRAD_RTOL, atol=1e-8 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_convert_round_trip_and_missing_leaf(setups):
    _, params, _, tparams = setups()
    tree = params_numpy(params)
    back = convert.voliro_params_to_numpy(tparams)
    for path, w in jax.tree_util.tree_leaves_with_path(tree):
        got = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        assert np.array_equal(got, w), jax.tree_util.keystr(path)
    with pytest.raises(KeyError, match="var_z_unc"):
        convert.voliro_params_from_numpy({k: v for k, v in tree.items() if k != "var_z_unc"},
                                         device="cpu")
    with pytest.raises(KeyError, match="gp_b/kern_len_unc"):
        convert.voliro_params_from_numpy(
            dict(tree, gp_b={k: v for k, v in tree["gp_b"].items() if k != "kern_len_unc"}),
            device="cpu")


def test_adjoint_parallel_is_refused():
    with pytest.raises(ValueError, match="adjoint"):
        Voliro(config(adjoint="parallel"), device="cpu")


# --- streaming ---------------------------------------------------------------


@pytest.fixture(scope="module")
def stream(setups):
    jm, params, pm, tparams = setups(filter_dt=0.01)
    u, y = voliro_batch(np.random.default_rng(7), b=B, t=12)
    return jm, params, pm, tparams, u, y


def test_filter_init_and_step_match_jax(stream):
    jm, params, pm, tparams, u, y = stream
    want_x = np.asarray(jm.filter_init(params, u[:, :4], y[:, :4]))
    x = pm.filter_init(tparams, u[:, :4], y[:, :4])
    np.testing.assert_allclose(x.numpy(), want_x, rtol=STREAM_RTOL, atol=1e-14)
    ops_j, ops = jm.filter_ops(params), pm.filter_ops(tparams)
    xj = jnp.asarray(want_x)
    step = jax.jit(lambda x, u_prev, y_new, eps: jm.filter_step(params, ops_j, x, u_prev, y_new,
                                                                None, eps=eps))
    for t in range(4, 8):
        kf, kx = jax.random.split(jax.random.PRNGKey(t))
        eps = (normal(kf, (B, pm.samples)), normal(kx, (B, pm.samples)))
        xj, (mj, vj) = step(xj, u[:, t - 1], y[:, t], tuple(jnp.asarray(e) for e in eps))
        x, (m, v) = pm.filter_step(tparams, ops, x, u[:, t - 1], y[:, t],
                                   eps=tuple(torch.tensor(e) for e in eps))
        for g, w in ((x, xj), (m, mj), (v, vj)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=STREAM_RTOL, atol=1e-14)


def test_forecast_matches_jax_and_filter_replay_is_filter_step(stream):
    jm, params, pm, tparams, u, y = stream
    ops_j, ops = jm.filter_ops(params), pm.filter_ops(tparams)
    x0 = pm.filter_init(tparams, u[:, :4], y[:, :4])
    key = jax.random.PRNGKey(9)
    kf, kx = jax.random.split(key)
    eps = tuple(torch.tensor(normal(k, (6, B, pm.samples))) for k in (kf, kx))
    want_m, want_v = jm.forecast(params, ops_j, jnp.asarray(x0.numpy()), u[:, 4:10], key)
    got_m, got_v = pm.forecast(tparams, ops, x0, u[:, 4:10], eps=eps)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=STREAM_RTOL, atol=1e-14)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=STREAM_RTOL, atol=1e-14)
    # filter_replay takes both draws of each step on axis 1: [K, 2, B, S, 1]
    eps_k = torch.randn((4, 2, B, pm.samples, 1), generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
    xr, (mr, _) = pm.filter_replay(tparams, ops, x0, u[:, 3:7], y[:, 4:8], eps=eps_k)
    x = x0
    for i in range(4):
        x, (m, _) = pm.filter_step(tparams, ops, x, u[:, 3 + i], y[:, 4 + i], eps=eps_k[i])
        torch.testing.assert_close(mr[:, i], m, rtol=0, atol=0)
    torch.testing.assert_close(xr, x, rtol=0, atol=0)


def test_filter_needs_filter_dt(setups):
    _, _, pm, tparams = setups()
    with pytest.raises(ValueError, match="filter_dt"):
        pm.filter_ops(tparams)


# --- outputs and serving -----------------------------------------------------


def test_outputs_voliro_writes_forces_and_var_dump(setups, voliro_dir, tmp_path):
    """OutputsVoliro with given params: voliro_forces.pdf and a
    var_dump.txt equal to the JAX package's, byte for byte."""
    jm, params, pm, tparams = setups()
    ds = VoliroFlipDS(64, 50, data_dir=voliro_dir)
    out = OutputsVoliro(str(tmp_path / "port"))
    out.set_ds(ds)
    out.set_model(pm, str(tmp_path / "port"))
    out.create_all(params=tparams)
    for f in ("voliro_forces.pdf", "voliro_forces.mat", "var_dump.txt"):
        assert os.path.getsize(tmp_path / "port" / f) > 0, f
    ref = JaxOutputs(str(tmp_path / "jax"))
    ref.set_model(jm, str(tmp_path / "jax"))
    ref.params = params
    ref.var_dump()
    assert ((tmp_path / "port" / "var_dump.txt").read_text()
            == (tmp_path / "jax" / "var_dump.txt").read_text())


def test_batch_predictors_reject_dict_predict_models(setups):
    """The counterpart of tests/test_serving.py's
    test_batch_predictor_rejects_dict_predict_models: Voliro's predict
    returns a dict, so the batch predictors refuse it at construction,
    naming the model."""
    _, _, pm, tparams = setups()
    with pytest.raises(TypeError, match="Voliro.predict returns dict, not a PredictOutput"):
        CompiledPredictor(pm, tparams, batch=1, seq_len=4)
    with pytest.raises(TypeError, match="PredictOutput"):
        BucketedPredictor(pm, tparams, 4, buckets=(1, 2))
