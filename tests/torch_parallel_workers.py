"""Rank programs of the port's multi-process tests (``run_ranks``).

Each ``*_ranks(rank, world, spec)`` runs in a process of a gloo group
that :func:`run_ranks` spawned, and returns numpy results. This module
imports no JAX: the JAX references are computed in the test process and
come in through ``spec`` as numpy arrays. The datasets' and models'
shapes are those of tests/test_trainer.py (SmokeDS) and
tests/test_cbfssm_model.py (TinyDS).
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback

import numpy as np
import torch


class TinyShape:
    """tests/test_cbfssm_model.TinyDS's dimensions, without JAX."""

    dim_u = 2
    dim_y = 1


class SmokeShape:
    """tests/test_trainer.SmokeDS's dimensions, without JAX."""

    dim_u = 1
    dim_y = 1


class Windows:
    """A windowed dataset from its arrays (``train_in_batch``, ...)."""

    def __init__(self, **arrays):
        self.__dict__.update(arrays)


def _child(rank, world, store, fn, spec, queue):
    torch.set_num_threads(1)
    from cbfssm_tpu_torch.parallel import distributed

    try:
        distributed.initialize(coordinator_address=f"file://{store}", num_processes=world,
                               process_id=rank, backend="gloo")
        queue.put((rank, fn(rank, world, spec), None))
    except Exception:  # the parent raises it with this rank's traceback
        queue.put((rank, None, traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int, spec, store_dir, timeout: float = 600.0) -> list:
    """``fn(rank, world, spec)`` in ``world`` spawned processes joined in
    one gloo group (a ``FileStore`` under ``store_dir``: no TCP port to
    collide with another test process), one torch thread each. Returns
    the results in rank order; raises with the failing rank's traceback."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    fd, store = tempfile.mkstemp(dir=store_dir, prefix="store")
    os.close(fd)
    os.unlink(store)
    procs = [ctx.Process(target=_child, args=(r, world, store, fn, spec, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks timed out after {timeout} s")
            try:
                rank, out, err = queue.get(timeout=1.0)
            except Exception:  # queue.Empty: check that every rank still lives
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results and r not in errors]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died: exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            (errors if err else results)[rank] = err or out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world} failed:\n{errors[rank]}")
    return [results[r] for r in range(world)]


# --- helpers ----------------------------------------------------------------


def _leaves(params):
    return [t.detach().cpu().numpy().copy() for t in params.tensors()]


def _grads(params):
    return [p.grad.detach().cpu().numpy().copy() for p in params.tensors()]


def _rollout_noise(arrays, device):
    from cbfssm_tpu_torch.models.cbfssm import RolloutNoise

    return RolloutNoise(*(torch.as_tensor(a, device=device) for a in arrays))


def _pp_loss_grads(pp, params, u, y, seed, noise):
    """A ParticleParallel loss, its aux and its mesh-reduced gradient."""
    from cbfssm_tpu_torch.parallel import DataParallel

    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    loss, aux = pp.loss(params.with_tensors(leaves), u, y, seed, True, None, noise)
    grads = list(torch.autograd.grad(loss, leaves))
    DataParallel(pp.mesh).reduce_grads(grads)
    return (float(loss), {k: float(v) for k, v in aux.items()},
            [g.cpu().numpy() for g in grads])


def _model_class(name: str):
    from cbfssm_tpu_torch.models import CBFSSM, PRSSM

    return {"cbfssm": CBFSSM, "prssm": PRSSM}[name]


def _params(name: str, tree, device):
    from cbfssm_tpu_torch import convert

    return {"cbfssm": convert.cbfssm_params_from_numpy,
            "prssm": convert.prssm_params_from_numpy}[name](tree, device=device)


# --- the data mesh: Trainer(mesh=) ------------------------------------------


def trainer_ranks(rank, world, spec):
    """The meshed Trainer: 2 epochs fed the JAX trainer's draws; one
    step's loss and gradient beside the unmeshed step's; the census of
    that step; the guard on a NaN row of rank 1; 5 epochs at
    epochs_per_dispatch 1 and 2 on the mesh and 2 unmeshed, with their
    censuses; restore-then-train against the unmeshed resume;
    process_rows / host_local_batch."""
    from cbfssm_tpu_torch.convert import cbfssm_params_to_numpy
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.parallel import DataParallel, census, distributed, make_mesh
    from cbfssm_tpu_torch.training import Trainer, checkpoint

    device = spec.get("device", "cpu")
    ds = Windows(**spec["ds"])
    cfg = spec["config"]
    mesh = make_mesh(world, device=device)
    init = _params("cbfssm", spec["init"], device) if spec.get("init") else None
    noises = spec.get("noises")
    out = {}

    def noise_fn(epoch, split, i, b, t_len):
        return _rollout_noise(noises[(epoch, split, i)], device) if noises else None

    if noises:  # 2 epochs against the JAX trainer
        tr = Trainer(CBFSSM(cfg, device=device), spec["dir"], seed=spec["seed"], mesh=mesh,
                     init_params=init, noise_fn=noise_fn)
        tr.train(ds, epochs=2)
        out.update(train_all=tr.train_all, test_all=tr.test_all,
                   params=cbfssm_params_to_numpy(tr.params))

    # one step, meshed and unmeshed, from the same params, batch and draws
    b = int(cfg["batch_size"])
    kw = dict(dtype=torch.float64, device=device)
    u = torch.as_tensor(ds.train_in_batch[:b], **kw)
    y = torch.as_tensor(ds.train_out_batch[:b], **kw)
    w = torch.ones(b, **kw)
    gen = torch.Generator(device=device).manual_seed(11)
    noise = CBFSSM(cfg, device=device).draw_noise(gen, u.shape[1], b)
    steps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, m in (("flat", None), ("mesh", mesh)):
            t = Trainer(CBFSSM(cfg, device=device), tmp, seed=1, mesh=m, init_params=init)
            t.init_state()
            loss, applied = t.train_step(u, y, w, None, noise)
            steps[name] = (float(loss), bool(applied), _grads(t.params), _leaves(t.params))
            if m is not None:
                with census.record() as items:
                    t.train_step(u, y, w, None, noise)
                out["census"] = items
                out["param_bytes"] = sum(p.numel() * p.element_size()
                                         for p in t.params.tensors())
        out["steps"] = steps
        if spec.get("guard", True):
            t = Trainer(CBFSSM(dict(cfg, skip_nonfinite_updates=True), device=device), tmp,
                        seed=1, mesh=mesh, init_params=init)
            t.init_state()
            before = _leaves(t.params)
            bad = u.clone()
            bad[b - 1, 0, 0] = float("nan")  # a row of the last rank's block
            _, applied = t.train_step(bad, y, w, None, noise)
            out["guard"] = (bool(applied), all(np.array_equal(a, c)
                                               for a, c in zip(before, _leaves(t.params))),
                            int(t.optimizer.state_dict()["state"].get(0, {}).get("step", 0)))

    if spec.get("half"):  # a model whose draws are one [T-1, B, S, 1] tensor
        from cbfssm_tpu_torch.models import CBFSSMHALF

        half = spec["half"]
        hu, hy, hn = (torch.as_tensor(half[k], **kw) for k in ("u", "y", "noise"))
        out["half"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, m in (("flat", None), ("mesh", mesh)):
                t = Trainer(CBFSSMHALF(half["config"], device=device), tmp, seed=1, mesh=m)
                t.init_state()
                loss, _ = t.train_step(hu, hy, torch.ones(hu.shape[0], **kw), None, hn)
                out["half"][name] = (float(loss), _grads(t.params))

    if spec.get("blocked"):  # Trainer(mesh=, epochs_per_dispatch=) over 5 epochs
        blocked = {}
        for name, epd, m in (("mesh_epd1", 1, mesh), ("mesh_epd2", 2, mesh),
                             ("flat_epd2", 2, None)):
            if m is None and rank != 0:
                continue
            with tempfile.TemporaryDirectory() as tmp:
                t = Trainer(CBFSSM(cfg, device=device), tmp, seed=4, mesh=m,
                            epochs_per_dispatch=epd)
                with census.record() as items:
                    t.train(ds, epochs=5)
                blocked[name] = (t.train_all, t.test_all, _leaves(t.params),
                                 census.census(items))
        out["blocked"] = blocked

    if noises:  # restore the 2-epoch run's last checkpoint, then one epoch
        resumed = {}
        for name, m in (("flat", None), ("mesh", mesh)):
            if m is None and rank != 0:
                continue
            t = Trainer(CBFSSM(cfg, device=device), spec["dir"], seed=7, mesh=m)
            t.restore(checkpoint.LAST)
            resumed[name] = t._epoch_train(ds, t.dp.round_up_batch(b), 0)
        out["resumed"] = resumed

    rows = distributed.process_rows(mesh, 8)
    x = np.arange(8 * 3, dtype=np.float64).reshape(8, 3)
    local = distributed.host_local_batch(mesh, x[rows], global_batch=8)
    try:
        distributed.host_local_batch(mesh, x[:3], global_batch=8)
        row_error = None
    except ValueError as exc:
        row_error = str(exc)
    block = DataParallel(mesh).shard_rows(torch.arange(16).reshape(8, 2), dim=0)
    out["rows"] = (rows, local.cpu().numpy(), str(local.device), row_error, block.numpy())
    return out


# --- the particle mesh: ParticleParallel, and the seed-sharded lanes ---------


def particle_ranks(rank, world, spec):
    """ParticleParallel on a particle mesh of ``world``: each case's loss,
    aux and gradient with the JAX shard draws; the divisibility error; a
    Trainer(ParticleParallel) directory; then the seed-sharded
    MultiSeedTrainer and SweepTrainer against their unsharded runs, and
    the census of a sharded lane step."""
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.parallel import ParticleParallel, census, make_mesh
    from cbfssm_tpu_torch.training import MultiSeedTrainer, SweepTrainer, Trainer

    device = spec.get("device", "cpu")
    mesh = make_mesh(world, axis_name="particle", device=device)
    out = {"cases": {}}
    for key, case in spec["cases"].items():
        pp = ParticleParallel(_model_class(case["model"]), case["config"], mesh, device=device)
        params = _params(case["model"], case["params"], device)
        noise = case.get("noises")
        if noise is not None:
            noise = noise[pp.shard_index]
            noise = (_rollout_noise(noise, device) if case["model"] == "cbfssm"
                     else torch.as_tensor(noise[0], device=device))
        out["cases"][key] = _pp_loss_grads(pp, params, case["u"], case["y"],
                                           case.get("seed", 0), noise)
    try:
        ParticleParallel(CBFSSM, dict(spec["trainer_config"], samples=3), mesh, device=device)
        out["divide_error"] = None
    except ValueError as exc:
        out["divide_error"] = str(exc)
    ds = Windows(**spec["ds"])
    pp = ParticleParallel(CBFSSM, spec["trainer_config"], mesh, device=device)
    tr = Trainer(pp, spec["dir"], seed=0)
    tr.train(ds, epochs=2)
    out["pp_train_all"] = tr.train_all

    # seed-sharded lanes: `lanes` lanes over the data axis, against the
    # unsharded run (rank 0)
    lanes = spec["lanes"]
    data_mesh = make_mesh(world, device=device)
    lane_cfg = spec["trainer_config"]
    runs = {}
    for name, m in (("flat", None), ("mesh", data_mesh)):
        if m is None and rank != 0:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            ms = MultiSeedTrainer(CBFSSM(lane_cfg, device=device), tmp, n_seeds=lanes, seed=2,
                                  mesh=m)
            ms.train(ds, epochs=2)
            runs[name] = (np.stack(ms.train_all), np.stack(ms.test_all), ms.best_seed(),
                          _leaves(ms.params))
            sw = SweepTrainer(CBFSSM, lane_cfg, {"k_factor": spec["k_factor"]},
                              os.path.join(tmp, "sweep"), mesh=m, device=device)
            sw.train(ds, epochs=1)
            runs[name] += (np.stack(sw.train_all), sw.best_config())
    out["lanes"] = runs
    try:
        MultiSeedTrainer(CBFSSM(lane_cfg, device=device), spec["dir"], n_seeds=lanes + 1,
                         mesh=data_mesh)
        out["lane_error"] = None
    except ValueError as exc:
        out["lane_error"] = str(exc)

    # the census of one sharded lane step
    with tempfile.TemporaryDirectory() as tmp:
        ms = MultiSeedTrainer(CBFSSM(lane_cfg, device=device), tmp, n_seeds=lanes, mesh=data_mesh)
        ms.init_state()
        data_u, data_y = ms._stage("train", ds.train_in_batch, ds.train_out_batch)
        b = int(lane_cfg["batch_size"])
        idx, w = ms._epoch_indices(data_u.shape[0], b, shuffle=True)
        rows = torch.as_tensor(idx[:, 0].astype(np.int64), device=device)
        noises = ms._noises(0, 0, 0, b, data_u.shape[1])
        w = torch.as_tensor(w[:, 0], device=device)
        with census.record() as items:
            ms.train_step(data_u[rows], data_y[rows], w, noises)
        out["lane_census"] = items
        out["lane_ids"] = list(ms.lanes)
    return out


# --- the ('data', 'particle') grid --------------------------------------------


def grid_ranks(rank, world, spec):
    """A 2 x 2 ('data', 'particle') mesh: ParticleParallel with the JAX
    shard draws, the shard indices and seeds, DataParallel on it and on a
    particle-only mesh, process_mesh's errors and rows, and a Trainer
    over the grid."""
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.parallel import (DataParallel, ParticleParallel, distributed,
                                           make_mesh)
    from cbfssm_tpu_torch.training import Trainer

    device = "cpu"
    mesh = distributed.process_mesh((2, 2), ("data", "particle"), device=device)
    case = spec["case"]
    pp = ParticleParallel(CBFSSM, case["config"], mesh, data_axis="data", device=device)
    params = _params("cbfssm", case["params"], device)
    noise = _rollout_noise(case["noises"][pp.shard_index], device)
    out = {"case": _pp_loss_grads(pp, params, case["u"], case["y"], 0, noise),
           "shard": (pp.shard_index, pp.shard_seed(0))}
    dp = DataParallel(mesh)
    flat = DataParallel(make_mesh(world, axis_name="particle", device=device))
    out["dp"] = (dp.n, dp.round_up_batch(5), flat.n, flat.round_up_batch(5))
    errors = []
    for sizes, names in (((3, 2), ("data", "particle")), ((2, 2), ("data",))):
        try:
            distributed.process_mesh(sizes, names, device=device)
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    out["mesh_errors"] = errors
    out["rows"] = distributed.process_rows(mesh, 8, axis_name="data")
    ds = Windows(**spec["ds"])
    pp = ParticleParallel(CBFSSM, spec["trainer_config"], mesh, data_axis="data",
                          device=device)
    tr = Trainer(pp, spec["dir"], mesh=mesh)
    tr.train(ds, epochs=2)
    out["train_all"] = tr.train_all
    return out


def _leaves_of_tree(tree):
    """A nested dict of arrays as a flat list, in sorted key order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves_of_tree(tree[k])]
    return [np.asarray(tree)]


def particle_seeded_ranks(rank, world, spec):
    """ParticleParallel drawing from its shard seeds (no ready-made
    draws) beside the serial emulation on this rank: each shard's S / n
    particles from ``fold_seed(seed, idx)``, one shard after the other,
    summed. Returns both (loss, gradient leaves)."""
    from cbfssm_tpu_torch.config import as_config
    from cbfssm_tpu_torch.models import CBFSSM
    from cbfssm_tpu_torch.parallel import ParticleParallel, make_mesh
    from cbfssm_tpu_torch.streams import fold_seed

    device, seed = spec["device"], spec["seed"]
    cfg = as_config(spec["config"])
    pp = ParticleParallel(CBFSSM, cfg, make_mesh(world, axis_name="particle", device=device),
                          device=device)
    params = pp.init(torch.Generator(device=device).manual_seed(0))
    kw = dict(dtype=torch.float64, device=device)
    u, y = torch.as_tensor(spec["u"], **kw), torch.as_tensor(spec["y"], **kw)
    loss, _, grads = _pp_loss_grads(pp, params, u, y, seed, None)
    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    total = 0.0
    for idx in range(world):
        gen = torch.Generator(device=device).manual_seed(fold_seed(seed, idx))
        _, aux = pp.local_model.loss(params.with_tensors(leaves), u, y, gen, True)
        total = total + aux["particle_sum"]
    serial = -(total / cfg.samples + aux["global_term"])
    return ((loss, grads),
            (float(serial.detach()),
             [g.cpu().numpy() for g in torch.autograd.grad(serial, leaves)]))
