"""Multi-process training in the port (``cbfssm_tpu_torch.parallel``),
on gloo process groups of CPU processes.

The JAX package proves its mesh code on 8 virtual CPU devices of one
program; the port is one process per GPU, so these tests spawn ranks
(:func:`run_ranks`) joined by a ``FileStore`` under the test's temporary
directory. The rank programs live in ``tests/torch_parallel_workers.py``
and import no JAX; the JAX references are computed here and passed in
as numpy. This module imports JAX only inside the fixtures that need
it, so its ``cuda`` twins run where the JAX package does not import.

- the meshed ``Trainer`` on 2 ranks, fed the JAX trainer's draws,
  reproduces the JAX ``Trainer`` on a 2-device mesh over 2 epochs (the
  tolerance of tests/test_torch_train.py's trainer parity);
- one meshed step equals the unmeshed step at rtol 1e-10 in loss and
  every gradient leaf (the global KL counted once, not once per rank);
- its census is one gradient all-reduce of the parameter bytes and one
  scalar reduction; a NaN in one rank's rows makes both skip; a
  restored run trains on the mesh as unmeshed;
- ``initialize``, ``process_mesh``, ``make_mesh``, ``process_rows`` /
  ``host_local_batch``, ``pad_batch`` and the census' contract check.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.parallel import census, distributed, make_mesh, pad_batch
from cbfssm_tpu_torch.parallel.census import Collective
from cbfssm_tpu_torch.training import Trainer
import torch_parallel_workers as workers  # tests/ (pytest puts it on sys.path)

RTOL_MESH = 1e-10  # meshed against unmeshed: summation order only


def run_ranks(fn, world: int, spec, store_dir) -> list:
    """``fn(rank, world, spec)`` of tests/torch_parallel_workers.py in
    ``world`` spawned gloo ranks (``torch.multiprocessing`` spawn, a
    ``FileStore`` under ``store_dir``, one torch thread each); their
    results in rank order."""
    return workers.run_ranks(fn, world, spec, str(store_dir))


def smoke_config(**overrides):
    """tests/test_trainer.smoke_config without its JAX dataset class."""
    return dict({
        "ds": workers.SmokeShape, "batch_size": 8, "shuffle": 100, "dim_x": 2,
        "ind_pnt_num": 5, "samples": 4, "learning_rate": 0.05,
        "loss_factors": np.asarray([0.5, 0.0]), "k_factor": 50.0, "recog_len": 4,
        "zeta_pos": 2.0, "zeta_mean": 0.0025, "zeta_var": 0.0001,
        "var_x": np.asarray([0.002**2] * 2), "var_y": np.asarray([1.0] * 2), "gp_var": 0.25,
        "gp_len": 2.0, "dtype": "float64", "jitter": 1e-8,
    }, **overrides)


def smoke_arrays(seq_len=12, seq_stride=4, n=160, seed=0):
    """tests/test_trainer.SmokeDS's windows, with the port's data layer."""
    from cbfssm_tpu_torch.data.base import BaseDS

    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, size=(n, 1))
    x = np.zeros(n)
    for i in range(1, n):
        x[i] = 0.8 * x[i - 1] + 0.3 * np.tanh(u[i - 1, 0])
    y = (x + rng.normal(0, 0.01, size=n))[:, None]
    base = BaseDS(seq_len, seq_stride)
    base.normalize_init(u, y)
    base.train_in = base.normalize(u, "in")[None, :120]
    base.train_out = base.normalize(y, "out")[None, :120]
    base.test_in = base.normalize(u, "in")[None, 120:]
    base.test_out = base.normalize(y, "out")[None, 120:]
    base.create_batches()
    return {k: np.asarray(getattr(base, k)) for k in
            ("train_in_batch", "train_out_batch", "test_in_batch", "test_out_batch")}


def assert_leaves_close(got, want, rtol, atol=0.0):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"leaf {k}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


# --- in this process -----------------------------------------------------------


def test_smoke_arrays_equal_jax_smoke_ds():
    pytest.importorskip("flax")
    from tests.test_trainer import SmokeDS

    want = SmokeDS()
    for k, v in smoke_arrays().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("n,batch_size", [(3, 8), (8, 8), (1, 4)])
def test_pad_batch_equals_jax(n, batch_size):
    pytest.importorskip("flax")
    from cbfssm_tpu.parallel import pad_batch as jax_pad_batch

    arrays = (np.ones((n, 4, 1)), np.arange(n * 4 * 2, dtype=np.float64).reshape(n, 4, 2))
    got, w = pad_batch(arrays, batch_size)
    want, want_w = jax_pad_batch(arrays, batch_size)
    for g, v in zip(got + [w], list(want) + [want_w]):
        np.testing.assert_array_equal(g, np.asarray(v))
        assert g.dtype == np.asarray(v).dtype
    with pytest.raises(ValueError, match="larger"):
        pad_batch(arrays, n - 1)


@pytest.fixture
def fresh_initialize(monkeypatch):
    """distributed's latches as in a new process, and restored after."""
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(distributed, "_noop_latched", False)


def test_initialize_single_process_noop(fresh_initialize):
    distributed.initialize(num_processes=1)  # must not start a process group
    assert not dist.is_initialized()
    assert distributed._noop_latched and not distributed._initialized


def test_initialize_argless_after_noop_warns(fresh_initialize):
    """An argument-less call after the latched single-process no-op is
    suppressed, loudly (the torchrun environment is not read)."""
    distributed.initialize(num_processes=1)
    with pytest.warns(RuntimeWarning, match="argument-less call suppressed"):
        distributed.initialize()
    assert not dist.is_initialized()


def test_make_mesh_without_a_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(1, device="cpu")


@pytest.fixture
def group1(tmp_path, fresh_initialize):
    """A one-rank gloo group in this process, left after the test."""
    distributed.initialize(coordinator_address=f"file://{tmp_path / 'store'}", num_processes=1,
                           process_id=0, backend="gloo")
    yield
    distributed.shutdown()


def test_initialize_is_idempotent(group1, tmp_path):
    distributed.initialize(coordinator_address=f"file://{tmp_path / 'other'}",
                           num_processes=1, process_id=0, backend="gloo")
    distributed.initialize()
    assert dist.get_world_size() == 1 and distributed._initialized


def test_process_mesh_and_make_mesh_errors(group1):
    mesh = distributed.process_mesh((1,), ("data",), device="cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
    with pytest.raises(ValueError, match="devices"):
        distributed.process_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="equal length"):
        distributed.process_mesh((1, 1), ("data",), device="cpu")
    with pytest.raises(ValueError, match="only 1 device"):
        make_mesh(2, device="cpu")


def test_census_records_kinds_and_payloads(group1):
    x = torch.ones(5, dtype=torch.float64)
    with census.record() as items:
        dist.all_reduce(x)
        dist.broadcast(x, 0)
        dist.all_gather([torch.zeros(5, dtype=torch.float64)], x)
        dist.barrier()
    assert [c.kind for c in items] == ["all-reduce", "collective-broadcast", "all-gather",
                                       "barrier"]
    assert [c.result_bytes for c in items] == [40, 40, 40, 0]
    assert items[0].shapes == ("f64[5]",) and items[0].result_elements == 5
    assert items[0].op_name == "c10d.allreduce_.default"
    assert census.census(items) == {"all-reduce": 1, "collective-broadcast": 1,
                                    "all-gather": 1, "barrier": 1}
    text = census.describe(items)
    assert text.splitlines()[0] == "collective census: 4 instruction(s)"
    assert census.describe([]) == "collective census: none (embarrassingly parallel)"
    assert census.collectives(dist.all_reduce, torch.ones(2)) == [
        Collective("all-reduce", ("f32[2]",), 8, "c10d.allreduce_.default", 2)]


def test_census_contract_rejects_gathers_and_oversized_payloads(group1):
    """assert_data_parallel_contract: an all-gather (a batch moving
    between ranks) and an all-reduce above the parameter bound both
    fail, with the JAX package's messages."""
    with census.record() as items:
        dist.all_gather([torch.zeros(3)], torch.ones(3))
    with pytest.raises(AssertionError, match=r"non-psum collective\(s\) in step: all-gather"):
        census.assert_data_parallel_contract(items, 1024, context="step")
    with census.record() as items:
        dist.all_reduce(torch.ones(300, dtype=torch.float64))
    with pytest.raises(AssertionError, match="exceed 1024 B.*2400 B"):
        census.assert_data_parallel_contract(items, 1024)
    assert census.assert_data_parallel_contract(items, 2400) == items


def test_world_of_one_mesh_trains_bitwise_as_unmeshed(group1, tmp_path):
    """A mesh of one rank changes no number: losses and params of a
    2-epoch run bitwise equal the unmeshed run's."""
    ds = workers.Windows(**smoke_arrays())
    runs = {}
    for name, mesh in (("flat", None), ("mesh", make_mesh(device="cpu"))):
        tr = Trainer(CBFSSM(smoke_config(), device="cpu"), str(tmp_path / name), seed=2,
                     mesh=mesh)
        tr.train(ds, epochs=2)
        runs[name] = (tr.train_all, tr.test_all, workers._leaves(tr.params))
    assert runs["mesh"][:2] == runs["flat"][:2]
    for a, b in zip(runs["mesh"][2], runs["flat"][2]):
        assert np.array_equal(a, b)


def test_filter_pool_mesh_names_its_queue_item():
    from cbfssm_tpu_torch.serving import FilterPool

    with pytest.raises(ValueError, match=r"A6\.1b"):
        FilterPool(object(), None, capacity=2, mesh=object())


# --- two ranks -----------------------------------------------------------------


def jax_trainer_reference(tmp):
    """The JAX Trainer on a 2-device data mesh over 2 epochs of SmokeDS,
    its init params and the draws of every batch (tests/test_torch_train
    .jax_key_noise), as numpy."""
    pytest.importorskip("flax")
    import jax

    from cbfssm_tpu.models import CBFSSM as JaxCBFSSM
    from cbfssm_tpu.parallel import make_mesh as jax_make_mesh
    from cbfssm_tpu.training import Trainer as JaxTrainer
    from tests.test_torch_cbfssm import params_numpy
    from tests.test_torch_train import jax_key_noise
    from tests.test_trainer import SmokeDS
    from tests.test_trainer import smoke_config as jax_smoke_config

    seed = 3
    jm = JaxCBFSSM(jax_smoke_config())
    jt = JaxTrainer(jm, str(tmp / "jax"), mesh=jax_make_mesh(2), seed=seed)
    jt.train(SmokeDS(), epochs=2)
    noise_fn = jax_key_noise(CBFSSM(smoke_config(), device="cpu"), seed)
    noises = {}
    for epoch in range(2):
        for split, batches in ((0, 4), (1, 1)):
            for i in range(batches):
                n = noise_fn(epoch, split, i, 8, 12)
                noises[(epoch, split, i)] = [getattr(n, f.name).numpy()
                                             for f in dataclasses.fields(n)]
    return {"train_all": jt.train_all, "test_all": jt.test_all,
            "params": params_numpy(jt.params), "seed": seed,
            "init": params_numpy(jm.init(jax.random.PRNGKey(seed))), "noises": noises}


def half_case():
    """A CBFSSMHALF ('rnn') batch of 4 rows and its draws, at
    tests/test_other_models.half_config's shapes."""
    from tests.test_other_models import half_config

    rng = np.random.default_rng(5)
    cfg = dict(half_config("rnn"), ds=workers.TinyShape)
    return {"config": cfg, "u": rng.normal(size=(4, 8, 2)), "y": rng.normal(size=(4, 8, 1)),
            "noise": rng.normal(size=(7, 4, cfg["samples"], 1))}


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    ref = jax_trainer_reference(tmp)
    spec = {"ds": smoke_arrays(), "config": smoke_config(), "dir": str(tmp / "port"),
            "seed": ref["seed"], "init": ref["init"], "noises": ref["noises"],
            "half": half_case(), "blocked": True}
    return ref, run_ranks(workers.trainer_ranks, 2, spec, tmp)


def test_meshed_trainer_matches_jax_trainer(trainer_run):
    """2 ranks of 4 rows each against the JAX Trainer on a 2-device
    mesh, the same init, shuffles and draws: per-epoch losses and final
    params at rtol 1e-6 (test_trainer_matches_jax_trainer's)."""
    from tests.test_torch_train import assert_trees_close

    ref, ranks = trainer_run
    for out in ranks:
        np.testing.assert_allclose(out["train_all"], ref["train_all"], rtol=1e-6)
        np.testing.assert_allclose(out["test_all"], ref["test_all"], rtol=1e-6)
        assert_trees_close(out["params"], ref["params"], rtol=1e-6, atol=1e-12)


def test_ranks_hold_equal_losses_and_params(trainer_run):
    _, (r0, r1) = trainer_run
    assert r0["train_all"] == r1["train_all"] and r0["test_all"] == r1["test_all"]
    for a, b in zip(workers._leaves_of_tree(r0["params"]), workers._leaves_of_tree(r1["params"])):
        assert np.array_equal(a, b)


def test_meshed_step_counts_the_global_term_once(trainer_run):
    """One meshed step against the unmeshed step on the same params,
    batch and draws: the loss and every gradient leaf at rtol 1e-10.
    Summed per-rank losses (plain DDP) would count the inducing-point KL
    once per rank and fail this."""
    _, ranks = trainer_run
    for out in ranks:
        flat, mesh = out["steps"]["flat"], out["steps"]["mesh"]
        assert flat[1] and mesh[1]
        np.testing.assert_allclose(mesh[0], flat[0], rtol=RTOL_MESH)
        assert_leaves_close(mesh[2], flat[2], rtol=RTOL_MESH)
        assert_leaves_close(mesh[3], flat[3], rtol=RTOL_MESH)


def test_meshed_step_of_a_recognition_model_equals_unmeshed(trainer_run):
    """CBFSSMHALF, whose draws are one [T-1, B, S, 1] tensor
    (``noise_rows`` cuts its axis 1): loss and gradient at rtol 1e-10."""
    _, ranks = trainer_run
    for out in ranks:
        flat, mesh = out["half"]["flat"], out["half"]["mesh"]
        np.testing.assert_allclose(mesh[0], flat[0], rtol=RTOL_MESH)
        assert_leaves_close(mesh[1], flat[1], rtol=RTOL_MESH, atol=1e-14)


def test_noise_rows_cuts_each_field_on_its_batch_axis():
    from cbfssm_tpu_torch.models.cbfssm import RolloutNoise
    from cbfssm_tpu_torch.models.voliro import VoliroNoise
    from cbfssm_tpu_torch.parallel import noise_rows

    t, b, s = 5, 4, 3
    g = torch.Generator().manual_seed(0)
    rows = slice(1, 3)
    v = VoliroNoise(torch.randn(b, t, s, 1, generator=g), torch.randn(t, b, s, 1, generator=g),
                    torch.randn(t - 1, b, s, 1, generator=g))
    got = noise_rows(v, rows)
    assert torch.equal(got.force, v.force[rows]) and torch.equal(got.backward, v.backward[:, rows])
    assert torch.equal(got.forward, v.forward[:, rows])
    r = RolloutNoise(*(torch.randn(shape, generator=g)
                       for shape in ((t, 2, b, s, 1), (t, 2, b, s, 1), (t - 1, b, s, 1))))
    got = noise_rows(r, rows)
    assert torch.equal(got.backward_noise, r.backward_noise[:, :, rows])
    assert torch.equal(got.backward_eps, r.backward_eps[:, :, rows])
    assert torch.equal(got.forward_eps, r.forward_eps[:, rows])
    assert torch.equal(noise_rows(r.forward_eps, rows), r.forward_eps[:, rows])


def test_meshed_step_census_is_one_gradient_all_reduce(trainer_run):
    """The step's collectives: one all-reduce of exactly the parameter
    bytes (the flattened gradient) and one of the per-particle scalars;
    nothing batch-sized moves."""
    _, ranks = trainer_run
    for out in ranks:
        items = census.assert_data_parallel_contract(out["census"], out["param_bytes"],
                                                     context="Trainer.train_step")
        assert census.census(items) == {"all-reduce": 2}
        grads = [c for c in items if c.result_bytes == out["param_bytes"]]
        scalars = [c for c in items if c.result_elements <= 8]
        assert len(grads) == 1 and len(scalars) == 1, census.describe(items)


def test_nan_in_one_ranks_rows_skips_the_update_on_every_rank(trainer_run):
    _, ranks = trainer_run
    for out in ranks:
        applied, unchanged, adam_steps = out["guard"]
        assert not applied and unchanged and adam_steps == 0


def test_blocked_trainer_on_mesh_equals_per_epoch(trainer_run):
    """Trainer(mesh=, epochs_per_dispatch=2) over 5 epochs (two blocks
    and a tail; tests/test_trainer.py:365 for the port): bitwise the
    meshed per-epoch run, with the same collectives (the gradient
    all-reduce once a step inside the blocks too), and the unmeshed
    blocked run at rtol 1e-10."""
    _, ranks = trainer_run
    flat = ranks[0]["blocked"]["flat_epd2"]
    for out in ranks:
        per_epoch, blocked = out["blocked"]["mesh_epd1"], out["blocked"]["mesh_epd2"]
        assert blocked[:2] == per_epoch[:2]
        for a, b in zip(blocked[2], per_epoch[2]):
            assert np.array_equal(a, b)
        assert blocked[3] == per_epoch[3] and blocked[3]["all-reduce"] > 0
        np.testing.assert_allclose(blocked[0], flat[0], rtol=RTOL_MESH)
        np.testing.assert_allclose(blocked[1], flat[1], rtol=RTOL_MESH)
        assert_leaves_close(blocked[2], flat[2], rtol=RTOL_MESH)
    assert flat[3] == {}


def test_restore_then_train_on_mesh_matches_unmeshed(trainer_run):
    """Resuming from model.ckpt on the mesh gives the unmeshed resume's
    epoch loss (tests/test_trainer.py:155; here at rtol 1e-10)."""
    _, ranks = trainer_run
    flat = ranks[0]["resumed"]["flat"]
    for out in ranks:
        np.testing.assert_allclose(out["resumed"]["mesh"], flat, rtol=RTOL_MESH)


def test_process_rows_and_host_local_batch(trainer_run):
    _, ranks = trainer_run
    x = np.arange(8 * 3, dtype=np.float64).reshape(8, 3)
    for rank, out in enumerate(ranks):
        rows, local, device, error, block = out["rows"]
        np.testing.assert_array_equal(rows, np.arange(4) + 4 * rank)
        np.testing.assert_array_equal(local, x[rows])
        np.testing.assert_array_equal(block, np.arange(16).reshape(8, 2)[rows])
        assert device == "cpu"
        assert "process_rows" in error


# --- on the card: gloo ranks on cuda:0 -----------------------------------------


@pytest.mark.cuda
def test_cuda_meshed_step_equals_unmeshed(cuda_device, tmp_path):
    """Two gloo ranks on the one card (NCCL takes one rank a GPU), the
    kernel path: a meshed step's loss, gradient and params against the
    unmeshed step at rtol 1e-10, the census as on the CPU."""
    spec = {"ds": smoke_arrays(), "config": smoke_config(gp_impl="pallas"),
            "dir": str(tmp_path / "m"), "device": "cuda", "guard": False}
    for out in run_ranks(workers.trainer_ranks, 2, spec, tmp_path):
        flat, mesh = out["steps"]["flat"], out["steps"]["mesh"]
        np.testing.assert_allclose(mesh[0], flat[0], rtol=RTOL_MESH)
        assert_leaves_close(mesh[2], flat[2], rtol=RTOL_MESH)
        assert_leaves_close(mesh[3], flat[3], rtol=RTOL_MESH)
        census.assert_data_parallel_contract(out["census"], out["param_bytes"])
        assert len(out["census"]) == 2


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_particle_parallel_equals_its_serial_emulation(device, tmp_path):
    """tests/test_particle_parallel.py's serial emulation, with the port's
    own draws: ParticleParallel on a particle mesh of 2, each rank drawing
    its S / 2 particles from its shard seed, against both shards run one
    after the other in one process (loss and every gradient leaf at rtol
    1e-10). On the card: gloo ranks on cuda:0, the kernel path."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(4)
    spec = {"device": device, "seed": 9,
            "config": smoke_config(samples=8, gp_impl="pallas"),
            "u": rng.normal(size=(4, 12, 1)), "y": rng.normal(size=(4, 12, 1))}
    for (loss, grads), (serial, serial_grads) in run_ranks(workers.particle_seeded_ranks, 2,
                                                           spec, tmp_path):
        np.testing.assert_allclose(loss, serial, rtol=RTOL_MESH)
        assert_leaves_close(grads, serial_grads, rtol=RTOL_MESH, atol=1e-14)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_loss_value_is_the_mesh_loss_formula(device):
    """The loss a model returns is -(particle_sum / particle_divisor +
    global_term) of its aux bit for bit: the value ``mesh_loss`` forms
    from the summed terms, so a one-rank mesh reports the unmeshed loss.
    On the card a division by a Python number is a product with its
    reciprocal, which differed from the division in the last bit of a
    one-rank NCCL run's loss (ROADMAP C12); it does so for ~13 % of
    values at 50 particles (not a power of two), so the card takes 64
    draws, the CPU (which divides) 4."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    model = CBFSSM(smoke_config(samples=50), device=device)
    arrays = smoke_arrays()
    u, y = (torch.tensor(arrays[k][:8], dtype=torch.float64, device=device)
            for k in ("train_in_batch", "train_out_batch"))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    for seed in range(64 if device == "cuda" else 4):
        loss, aux = model.loss(params, u, y, torch.Generator(device=device).manual_seed(seed))
        value = -(aux["particle_sum"] / aux["particle_divisor"] + aux["global_term"])
        assert torch.equal(loss, value), seed
