"""Particle parallelism and seed-sharded lanes in the port
(``cbfssm_tpu_torch.parallel.ParticleParallel``, ``MultiSeedTrainer`` /
``SweepTrainer`` with ``mesh=``) against the JAX package, on gloo ranks.

Each rank of the port draws its particles from its shard's seed; here
every rank is handed the JAX shard's draws instead (``jax_noise`` of the
local model at ``fold_in(key, idx)``, idx = p + n * d, the JAX
``_shard_key``), so loss and aux match the JAX ``ParticleParallel`` on
a ``make_mesh`` mesh of the same shape at rtol 1e-7 and the gradient at
tests/test_torch_train.py's GRAD_RTOL (1e-7): on a particle mesh of 2
(CBFSSM, PR-SSM's divisor of 1, one particle a shard, the hand adjoint)
and on a 2 x 2 ('data', 'particle') mesh. The cases of
tests/test_particle_parallel.py, tests/test_distributed.py and
tests/test_multiseed.py:189 that hold without a JAX mesh follow.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cbfssm_tpu.models import CBFSSM as JaxCBFSSM
from cbfssm_tpu.models import PRSSM as JaxPRSSM
from cbfssm_tpu.parallel import ParticleParallel as JaxParticleParallel
from cbfssm_tpu.parallel import make_mesh as jax_make_mesh
from cbfssm_tpu_torch import convert, model_store
from cbfssm_tpu_torch.models import CBFSSM
from tests.test_cbfssm_model import make_model
from tests.test_other_models import prssm_config
from tests.test_torch_cbfssm import batch, jax_noise, params_numpy, port_config
from tests.test_torch_other_models import jax_eps
from tests.test_torch_other_models import params_numpy as recog_params_numpy
from tests.test_torch_train import GRAD_RTOL

# tests/ is on sys.path under pytest (as on the card's machine, where another
# package named `tests` is installed)
import torch_parallel_workers as workers
from test_torch_distributed import run_ranks, smoke_arrays, smoke_config

RTOL = 1e-7
KEY = 7
LANES = 2
K_FACTOR = [10.0, 50.0]


def tiny(cfg: dict) -> dict:
    return dict(cfg, ds=workers.TinyShape)


def cbfssm_case(mesh, samples=8, data_axis=None):
    """A CBFSSM case: the JAX ParticleParallel's loss, aux and gradient
    on ``mesh`` and, for the port's ranks, the config, params, batch and
    every shard's draws."""
    jm = make_model(samples=samples)
    cfg = tiny(port_config(jm))
    params = jm.init(jax.random.PRNGKey(0))
    u, y = batch()
    key = jax.random.PRNGKey(KEY)
    pp = JaxParticleParallel(JaxCBFSSM, jm.config, mesh, data_axis=data_axis)
    (loss, aux), grads = jax.jit(jax.value_and_grad(lambda p: pp.loss(p, u, y, key),
                                                    has_aux=True))(params)
    n_p = mesh.shape["particle"]
    n_d = mesh.shape[data_axis] if data_axis else 1
    local = CBFSSM(dict(cfg, samples=samples // n_p), device="cpu")
    noises = {}
    for idx in range(n_p * n_d):
        n = jax_noise(local, jax.random.fold_in(key, idx), u.shape[1], u.shape[0] // n_d)
        noises[idx] = [getattr(n, f.name).numpy() for f in dataclasses.fields(n)]
    want_grads = convert.cbfssm_params_from_numpy(params_numpy(grads), device="cpu").tensors()
    return ({"model": "cbfssm", "config": cfg, "params": params_numpy(params), "u": u, "y": y,
             "noises": noises},
            (float(loss), {k: float(v) for k, v in aux.items()},
             [g.numpy() for g in want_grads]))


def prssm_case(mesh):
    cfg = dict(prssm_config("output"), samples=4)
    jm = JaxPRSSM(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    u, y = batch()
    key = jax.random.PRNGKey(KEY)
    pp = JaxParticleParallel(JaxPRSSM, jm.config, mesh)
    (loss, aux), grads = jax.jit(jax.value_and_grad(lambda p: pp.loss(p, u, y, key),
                                                    has_aux=True))(params)
    n = mesh.shape["particle"]
    noises = {idx: [jax_eps(jax.random.fold_in(key, idx), u.shape[1], u.shape[0],
                            4 // n).numpy()] for idx in range(n)}
    want_grads = convert.prssm_params_from_numpy(recog_params_numpy(grads), device="cpu")
    return ({"model": "prssm", "config": tiny(cfg), "params": recog_params_numpy(params),
             "u": u, "y": y, "noises": noises},
            (float(loss), {k: float(v) for k, v in aux.items()},
             [g.numpy() for g in want_grads.tensors()]))


def assert_case(got, want, rtol=RTOL, grad_rtol=GRAD_RTOL):
    loss, aux, grads = got
    want_loss, want_aux, want_grads = want
    np.testing.assert_allclose(loss, want_loss, rtol=rtol)
    assert set(aux) == set(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(aux[k], want_aux[k], rtol=rtol, atol=1e-12, err_msg=k)
    assert len(grads) == len(want_grads)
    for k, (g, w) in enumerate(zip(grads, want_grads)):
        np.testing.assert_allclose(g, w, rtol=grad_rtol, atol=1e-12, err_msg=f"leaf {k}")


@pytest.fixture(scope="module")
def particle_run(tmp_path_factory):
    """Two ranks on a particle mesh of 2, then the seed-sharded lanes."""
    tmp = tmp_path_factory.mktemp("pp")
    mesh = jax_make_mesh(2, axis_name="particle")
    cases, want = {}, {}
    cases["cbfssm"], want["cbfssm"] = cbfssm_case(mesh)
    cases["one_per_shard"], want["one_per_shard"] = cbfssm_case(mesh, samples=2)
    cases["prssm"], want["prssm"] = prssm_case(mesh)
    # the same case under the hand adjoint (the JAX reference is autodiff)
    cases["hand"] = dict(cases["cbfssm"], config=dict(cases["cbfssm"]["config"],
                                                      adjoint="hand", gp_impl="solve_free"))
    want["hand"] = want["cbfssm"]
    spec = {"cases": cases, "trainer_config": smoke_config(), "ds": smoke_arrays(),
            "dir": str(tmp / "pp"), "lanes": LANES, "k_factor": K_FACTOR}
    return spec, want, run_ranks(workers.particle_ranks, 2, spec, tmp)


@pytest.mark.parametrize("case", ["cbfssm", "prssm", "one_per_shard", "hand"])
def test_particle_mesh_matches_jax_particle_parallel(particle_run, case):
    """CBFSSM at S 8 (4 a shard); PR-SSM, whose divisor is 1 (its ELBO
    is not normalized by the particle count); one particle a shard,
    where the local divisor is 1 but the total still normalizes by S;
    the hand adjoint, against the JAX autodiff gradient."""
    _, want, ranks = particle_run
    for out in ranks:
        assert_case(out["cases"][case], want[case])


def test_hand_adjoint_composes_with_particle_parallel(particle_run):
    """tests/test_particle_parallel.py:160: the hand adjoint's sharded
    gradient equals autodiff's at rtol 1e-7."""
    _, _, ranks = particle_run
    for out in ranks:
        hand, auto = out["cases"]["hand"], out["cases"]["cbfssm"]
        assert hand[0] == auto[0]
        for g, w in zip(hand[2], auto[2]):
            np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-12)


def test_particle_count_must_divide(particle_run):
    _, _, ranks = particle_run
    for out in ranks:
        assert out["divide_error"] == ("samples (3) must divide by the particle axis size (2)")


def test_trainer_on_a_particle_mesh_trains_and_reloads(particle_run):
    """Trainer(ParticleParallel(...)) trains (losses finite and falling),
    and its directory reloads through load_trained_model as the
    full-config model: model_meta.json snapshots the adapter's ``model``."""
    spec, _, ranks = particle_run
    for out in ranks:
        assert np.isfinite(out["pp_train_all"]).all()
        assert out["pp_train_all"][-1] < out["pp_train_all"][0]
    assert ranks[0]["pp_train_all"] == ranks[1]["pp_train_all"]
    model, params = model_store.load_trained_model(spec["dir"], device="cpu")
    assert type(model) is CBFSSM and model.samples == 4
    want = CBFSSM(smoke_config(), device="cpu").init(torch.Generator().manual_seed(0))
    assert [t.shape for t in params.tensors()] == [t.shape for t in want.tensors()]


def test_seed_sharded_lanes_equal_the_unsharded_lanes(particle_run):
    """tests/test_multiseed.py:189 for the port: 2 lanes, 1 a rank, over 2
    epochs equal the unsharded 2-lane run (per-lane losses, test losses,
    best seed, final params), and so does a 2-point k_factor sweep."""
    _, _, ranks = particle_run
    flat = ranks[0]["lanes"]["flat"]
    for out in ranks:
        mesh = out["lanes"]["mesh"]
        for k in (0, 1):
            np.testing.assert_allclose(mesh[k], flat[k], rtol=1e-10)
        assert mesh[2] == flat[2]
        for a, b in zip(mesh[3], flat[3]):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(mesh[4], flat[4], rtol=1e-10)
        assert mesh[5] == flat[5]
    assert np.isfinite(flat[0]).all() and (flat[0][-1] < flat[0][0]).all()


def test_lane_count_must_divide_and_lane_steps_run_no_collective(particle_run):
    _, _, ranks = particle_run
    for rank, out in enumerate(ranks):
        assert out["lane_error"] == "n_seeds (3) must divide by the mesh axis 'data' (2)"
        assert out["lane_ids"] == [rank]
        assert out["lane_census"] == []


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """Four ranks on a 2 x 2 ('data', 'particle') mesh."""
    tmp = tmp_path_factory.mktemp("grid")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "particle"))
    case, want = cbfssm_case(mesh, data_axis="data")
    spec = {"case": case, "trainer_config": smoke_config(), "ds": smoke_arrays(),
            "dir": str(tmp / "grid")}
    return want, run_ranks(workers.grid_ranks, 4, spec, tmp)


def test_grid_matches_jax_particle_parallel(grid_run):
    """Batch rows over 'data' and particles over 'particle': loss, aux
    and gradient of every rank against the JAX 2 x 2 mesh."""
    want, ranks = grid_run
    for out in ranks:
        assert_case(out["case"], want)


def test_shard_seeds_unique_over_the_grid(grid_run):
    _, ranks = grid_run
    assert sorted(out["shard"][0] for out in ranks) == [0, 1, 2, 3]
    assert len({out["shard"][1] for out in ranks}) == 4


def test_data_parallel_on_multi_axis_and_particle_only_meshes(grid_run):
    _, ranks = grid_run
    for out in ranks:
        assert out["dp"] == (2, 6, 1, 5)


def test_process_mesh_errors_and_rows_on_the_grid(grid_run):
    _, ranks = grid_run
    for rank, out in enumerate(ranks):
        assert "needs 6 devices, have 4" in out["mesh_errors"][0]
        assert "equal length" in out["mesh_errors"][1]
        np.testing.assert_array_equal(out["rows"], np.arange(4) + 4 * (rank // 2))


def test_trainer_on_the_grid(grid_run):
    """tests/test_distributed.py's 2-D mesh Trainer: rows over 'data',
    particles over 'particle', losses finite and falling, equal on every
    rank."""
    _, ranks = grid_run
    losses = ranks[0]["train_all"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(out["train_all"] == losses for out in ranks)
