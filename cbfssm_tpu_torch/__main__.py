"""Command-line entry point: ``python -m cbfssm_tpu_torch <command>``
(port of ``cbfssm_tpu/__main__.py``).

    python -m cbfssm_tpu_torch info                        # torch, CUDA, registry
    python -m cbfssm_tpu_torch info run_output/robomove    # describe a trained dir
    python -m cbfssm_tpu_torch reproduce robomove --epochs 1
    python -m cbfssm_tpu_torch reproduce smallscale --task 0 --vmap-seeds
    python -m cbfssm_tpu_torch reproduce sarcos --check-data --data-dir DIR
    python -m cbfssm_tpu_torch eval run_output/robomove --out re_eval
    python -m cbfssm_tpu_torch serve run_output/robomove --port 8787
    python -m cbfssm_tpu_torch serve --filter run_output/robomove_half --capacity 32
    python -m cbfssm_tpu_torch export run_output/robomove --out art --seq-len 300
    python -m cbfssm_tpu_torch export run_output/robomove_half --out pool_art --kind pool
    python -m cbfssm_tpu_torch serve art                 # an exported predictor
    python -m cbfssm_tpu_torch serve --filter pool_art   # an exported pool
    python -m cbfssm_tpu_torch bench                     # headline steps/sec on the card

``reproduce`` runs the port's own drivers (``cbfssm_tpu_torch.run_*``),
``eval``, ``serve`` and ``export`` rebuild the model from the directory's
``model_meta.json`` alone (:mod:`cbfssm_tpu_torch.model_store`);
``serve --filter`` serves online-estimation sessions of a CBFSSMHALF or
Voliro directory (a ``FilterPool`` behind a ``FilterServer``). ``export``
writes a ``torch.export`` artifact (:mod:`cbfssm_tpu_torch.export`) that
``serve`` loads without the model classes. Every command that builds or
loads a model runs on the card unless given ``--device cpu``.
``reproduce`` trains with ``gp_impl='pallas'``: the time recursions' GP
predict runs the CUDA kernels (their plain versions on the CPU), and
``eval`` / ``serve`` / ``export`` rebuild that setting from the
directory. ``bench`` runs :func:`cbfssm_tpu_torch.bench.main` in this
process: the Voliro ELBO training steps a second on the card, and the
stages after it, as one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import sys

DRIVERS = {
    "spring": "run_spring",
    "smallscale": "run_smallscale",
    "sarcos": "run_sarcos",
    "robomove": "run_robomove",
    "voliro": "run_voliro",
}

# dataset classes of cbfssm_tpu_torch.data that are bases, not datasets
_DATASET_BASES = ("BaseDS", "DSManagerDS", "SystemIdDS")


def _driver(experiment: str):
    return importlib.import_module(f"cbfssm_tpu_torch.{DRIVERS[experiment]}")


def _dataset_class(name: str):
    """The loadable dataset class ``name`` of ``cbfssm_tpu_torch.data``,
    or None."""
    from cbfssm_tpu_torch import data
    from cbfssm_tpu_torch.data.base import BaseDS

    cls = getattr(data, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseDS) and name not in _DATASET_BASES:
        return cls
    return None


def cmd_info(args) -> int:
    if getattr(args, "model_dir", None):
        return _info_model_dir(args.model_dir)
    import torch

    import cbfssm_tpu_torch
    from cbfssm_tpu_torch import data, models

    print(f"cbfssm_tpu_torch from {os.path.dirname(cbfssm_tpu_torch.__file__)}")
    cuda = torch.cuda.is_available()
    devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
               for i in range(torch.cuda.device_count())] if cuda else []
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none'}, "
          f"devices: {devices + ['cpu']}")
    print("models:", ", ".join(
        n for n in ("CBFSSM", "CBFSSMHALF", "PRSSM", "Voliro") if hasattr(models, n)))
    print("datasets:", ", ".join(sorted(n for n in dir(data) if _dataset_class(n))))
    print("reproduction drivers:", ", ".join(sorted(DRIVERS)))
    return 0


def _info_model_dir(model_dir: str) -> int:
    """Describe a trained directory from its model_meta.json snapshot,
    without building the model or touching a device."""
    from cbfssm_tpu_torch import model_store
    from cbfssm_tpu_torch.training import checkpoint, multiseed

    try:
        meta = model_store.load_model_meta(model_dir)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"{model_dir}: {meta['model_class']} "
          f"(dim_u={meta['dim_u']}, dim_y={meta['dim_y']}, "
          f"seed={meta.get('seed', 0)}, ds={meta.get('ds_name')})")
    ckpts = [n for n in (checkpoint.BEST, checkpoint.LAST, multiseed.BEST_SEEDS,
                         multiseed.LAST_SEEDS)
             if checkpoint.exists(os.path.join(model_dir, n))]
    print("checkpoints:", ", ".join(ckpts) if ckpts else "none")
    updates = meta.get("config_updates")
    if updates:
        print(f"folded config updates ({updates.get('note')}): "
              f"{json.dumps(updates.get('values', {}))}")
    if meta.get("dropped_keys"):
        print("dropped (un-snapshottable) keys:", ", ".join(meta["dropped_keys"]))

    def show(value):
        value = model_store._decode(value)
        return value.tolist() if hasattr(value, "tolist") else json.dumps(value)

    print("config:")
    for k in sorted(meta["config"]):
        print(f"  {k}: {show(meta['config'][k])}")
    for k in sorted(meta.get("extra", {})):
        print(f"  extra.{k}: {show(meta['extra'][k])}")
    return 0


def cmd_reproduce(args) -> int:
    if args.check_data:
        from cbfssm_tpu_torch.data.check import check_experiment, report

        print(f"Checking raw data for '{args.experiment}' "
              f"(dir: {args.data_dir or 'packaged default'}):")
        ok = report(check_experiment(args.experiment, args.data_dir))
        print("all files OK — ready to train" if ok
              else "missing/invalid files — stage them and re-run")
        return 0 if ok else 1
    mod = _driver(args.experiment)
    if args.task is not None:
        n_tasks = len(getattr(mod, "datasets", ()))
        if not 0 <= args.task < max(n_tasks, 1):
            # reject an out-of-range index before any model work, not as
            # an IndexError deep inside the driver
            print(f"error: --task must be in [0, {n_tasks}) for {args.experiment}",
                  file=sys.stderr)
            return 2
    # drivers share a keyword vocabulary but not a full signature; pass
    # only what each main() accepts
    supported = set(inspect.signature(mod.main).parameters)
    requested = {
        "root": args.root,
        "data_dir": args.data_dir,
        "vmap_seeds": args.vmap_seeds or None,
        "task_list": [args.task] if args.task is not None else None,
        "epochs": args.epochs,
        "iterations": args.iterations,
        "train_iterations": args.train_iterations,
        "seq_len": args.seq_len,
        "seq_stride": args.seq_stride,
        "config_overrides": {"gp_impl": "pallas"},
        "device": args.device,
    }
    kwargs = {k: v for k, v in requested.items() if v is not None}
    dropped = {k for k in kwargs if k not in supported}
    if dropped:
        print(f"error: {args.experiment} does not accept {sorted(dropped)} "
              f"(it has {sorted(supported)})", file=sys.stderr)
        return 2
    mod.main(**kwargs)
    return 0


def cmd_export(args) -> int:
    """Export a trained directory as an artifact: a predictor at one
    (batch, seq_len), a single-session filter or a filter pool."""
    loaded = _load_checkpointed_model(args.model_dir, args.checkpoint, args.device)
    if loaded is None:
        return 2
    _meta, model, params = loaded
    from cbfssm_tpu_torch import export as export_mod

    try:
        if args.kind == "predictor":
            if args.seq_len is None:
                print("error: --seq-len is required for predictor exports", file=sys.stderr)
                return 2
            out_meta = export_mod.save_exported_predictor(
                args.out, model, params, args.batch, args.seq_len, condition=args.condition,
                platforms=tuple(args.platforms))
        elif args.kind == "pool":
            out_meta = export_mod.save_exported_pool(
                args.out, model, params, capacity=args.capacity, horizons=tuple(args.horizons),
                replay_buckets=tuple(args.replay_buckets), platforms=tuple(args.platforms))
        else:
            out_meta = export_mod.save_exported_filter(
                args.out, model, params, batch=args.batch, horizons=tuple(args.horizons),
                replay_buckets=tuple(args.replay_buckets), platforms=tuple(args.platforms))
    except (TypeError, ValueError) as e:
        # a model without the export's contract, or invalid options (e.g.
        # --replay-buckets 0)
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"exported {out_meta['kind']} ({out_meta['model_class']}, {args.checkpoint} "
          f"checkpoint) -> {args.out}")
    print(f"  platforms: {', '.join(out_meta['platforms'])}; dtype: {out_meta['dtype']}")
    return 0


def _load_checkpointed_model(model_dir: str, checkpoint: str, device: str, meta=None):
    """Read model_meta.json (unless the caller holds it) and rebuild
    ``(model, params)`` on ``device`` from the named checkpoint. Returns
    ``(meta, model, params)``, or None after printing the error (callers
    return 2)."""
    from cbfssm_tpu_torch import model_store

    if meta is None:
        try:
            meta = model_store.load_model_meta(model_dir)
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return None
    name = {"best": "best.ckpt", "last": "model.ckpt"}[checkpoint]
    try:
        model, params = model_store.load_trained_model(model_dir, name, device=device)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return None
    return meta, model, params


def _serve_until_interrupt(server, banner: str) -> int:
    """Foreground serve loop. SIGTERM (docker stop, systemd) gives the
    same ordered shutdown as Ctrl-C: stop accepting, drain in-flight
    futures, exit 0. It is raised as KeyboardInterrupt because calling
    server.close() inside the signal handler would deadlock (shutdown()
    waits for the serve loop, which is paused under the handler). The
    banner is printed after the handler is installed: supervisors read
    the address line as "ready", and a TERM racing it must already exit
    cleanly."""
    import signal

    def _term(_sig, _frame):
        raise KeyboardInterrupt

    prev = signal.signal(signal.SIGTERM, _term)
    try:
        # inside the try: a TERM racing the banner lands as a handled
        # KeyboardInterrupt, not an unhandled one between statements
        print(banner, flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", flush=True)
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.close()
    return 0


def _eval_outputs_class(model_class: str, ds_name: str):
    """The Outputs variant the producing driver uses: Voliro's
    dict-predict model writes its force plots and var dump; RoboMove
    datasets add the trajectory plots to the generic set."""
    from cbfssm_tpu_torch.outputs import Outputs, OutputsRoboMove, OutputsVoliro

    if model_class == "Voliro":
        return OutputsVoliro
    if ds_name in ("RoboMove", "RoboMoveSimple"):
        return OutputsRoboMove
    return Outputs


def cmd_eval(args) -> int:
    """Re-evaluate a trained directory without the script that trained
    it: rebuild (model, params) through model_store, the dataset from the
    recipe the trainer stamped into model_meta.json (or --dataset /
    --seq-len / --seq-stride), and write the producing driver's Outputs
    artifacts (mse.txt, calibration.txt, prediction plots)."""
    from cbfssm_tpu_torch import model_store

    try:
        meta = model_store.load_model_meta(args.model_dir)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    recipe = meta.get("dataset") or {}
    ds_name = args.dataset or recipe.get("name") or meta.get("ds_name")
    seq_len = args.seq_len or recipe.get("seq_len")
    seq_stride = args.seq_stride or recipe.get("seq_stride")
    if not ds_name or not seq_len or not seq_stride:
        print("error: no dataset recipe in model_meta.json (directory "
              "predates the stamp?) — pass --dataset/--seq-len/"
              "--seq-stride explicitly", file=sys.stderr)
        return 2
    ds_cls = _dataset_class(ds_name)
    if ds_cls is None:
        print(f"error: unknown dataset class {ds_name!r} (not in "
              "cbfssm_tpu_torch.data) — pass --dataset", file=sys.stderr)
        return 2
    loaded = _load_checkpointed_model(args.model_dir, args.checkpoint, args.device, meta=meta)
    if loaded is None:
        return 2
    _meta, model, params = loaded
    try:
        ds = ds_cls(int(seq_len), int(seq_stride), data_dir=args.data_dir)
    except Exception as e:
        print(f"error: could not build {ds_name}({seq_len}, {seq_stride}): {e}",
              file=sys.stderr)
        return 2
    out_dir = args.out or args.model_dir
    outputs_cls = _eval_outputs_class(meta["model_class"], ds_name)
    if outputs_cls.__name__ == "OutputsVoliro":
        print("note: Voliro is a dict-predict model — eval writes the "
              "force plots + var dump (no generic mse/calibration)")
    outputs = outputs_cls(out_dir)
    outputs.set_ds(ds)
    outputs.set_model(model, args.model_dir)
    outputs.create_all(params=params)
    rmse = outputs.get_last_rmse()
    if rmse is not None:
        print(f"RMSE: {rmse:f}")
    cal = outputs.last_calibration
    if cal is not None:
        print(f"NLL/point: {cal['nll']:f}  95%-band coverage: {cal['coverage'][0.95]:f}")
    print(f"artifacts -> {out_dir}")
    return 0


def _resolve_auth_token(args):
    """--auth-token beats the CBFSSM_AUTH_TOKEN env var (the env form
    keeps the secret off `ps` output); empty means open. Warns when a
    non-loopback bind goes up without a token."""
    token = args.auth_token
    if token is None:
        token = os.environ.get("CBFSSM_AUTH_TOKEN") or None
    if not token:
        token = None
    if token is None and args.host not in ("127.0.0.1", "localhost", "::1"):
        print("warning: non-loopback bind without --auth-token / "
              "CBFSSM_AUTH_TOKEN — any peer that can reach the port can "
              "mutate serving state (POST /v1/params)", file=sys.stderr)
    return token


def _exported_pool(args, ameta: dict):
    """The ExportedFilterPool of the artifact ``args.model_dir`` (meta
    ``ameta``), or None after printing the error."""
    if ameta.get("kind") != "filter_pool":
        print("error: --filter serves a trained directory or an exported POOL artifact "
              f"(kind 'filter_pool'); {args.model_dir} is kind "
              f"{ameta.get('kind', 'predictor')!r} — re-export with `export --kind pool`"
              + (" (for single-session filter artifacts use ExportedFilter in your own loop)"
                 if ameta.get("kind") == "filter" else ""), file=sys.stderr)
        return None
    if args.capacity is not None and args.capacity != ameta.get("capacity"):
        print(f"note: capacity is baked into the artifact ({ameta.get('capacity')}); "
              "ignoring --capacity", file=sys.stderr)
    if args.replay_buckets and sorted(args.replay_buckets) != sorted(
            ameta.get("replay_buckets", [])):
        print("note: the replay ladder is baked into the artifact "
              f"({ameta.get('replay_buckets', [])}); ignoring --replay-buckets",
              file=sys.stderr)
    from cbfssm_tpu_torch.export_pool import ExportedFilterPool

    try:
        return ExportedFilterPool(args.model_dir, device=args.device)
    except (ValueError, RuntimeError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _serve_filter(args, ameta) -> int:
    """``serve --filter``: a FilterPool behind a FilterServer, over the
    trained directory of a streaming model (CBFSSMHALF, Voliro) or, with
    the meta ``ameta`` of an exported pool artifact, an
    ExportedFilterPool."""
    from cbfssm_tpu_torch.serving_http import FilterServer

    if ameta is not None:
        pool = _exported_pool(args, ameta)
        if pool is None:
            return 2
    else:
        from cbfssm_tpu_torch.serving import FilterPool

        loaded = _load_checkpointed_model(args.model_dir, args.checkpoint, args.device)
        if loaded is None:
            return 2
        _meta, model, params = loaded
        try:
            pool = FilterPool(model, params,
                              capacity=32 if args.capacity is None else args.capacity,
                              replay_buckets=args.replay_buckets or None)
        except (TypeError, ValueError) as e:  # no streaming interface, bad capacity
            print(f"error: {e}", file=sys.stderr)
            return 2
    server = FilterServer(pool, args.host, args.port, max_wait_ms=args.max_wait_ms,
                          auth_token=_resolve_auth_token(args))
    m = server.meta()
    banner = (f"serving {m['model']} filter sessions (capacity "
              f"{m['capacity']}, recog_len {m['recog_len']}, dim_u "
              f"{m['dim_u']}, dim_y {m['dim_y']}, {m['dtype']}, "
              f"auth {'on' if server.auth_token else 'off'}) "
              f"on http://{server.host}:{server.port}")
    return _serve_until_interrupt(server, banner)


def cmd_serve(args) -> int:
    """Serve free-running prediction over HTTP from a trained directory
    (a BucketedPredictor over its best or last checkpoint) or an exported
    predictor artifact (an ExportedBatchPredictor, without the model
    classes), behind a PredictionServer. Routes: /healthz, /v1/meta,
    /v1/stats, /metrics, POST /v1/predict, POST /v1/params. With
    ``--filter``, online filter sessions instead (:func:`_serve_filter`),
    from a trained directory or an exported pool artifact."""
    exported_meta = os.path.join(args.model_dir, "meta.json")
    trained_meta = os.path.join(args.model_dir, "model_meta.json")
    ameta = None
    if os.path.isfile(exported_meta):
        with open(exported_meta) as f:
            ameta = json.load(f)
    elif not os.path.isfile(trained_meta):
        if args.filter:
            print("error: --filter serves a trained directory of a streaming model "
                  "(CBFSSMHALF/Voliro) or an exported pool artifact; "
                  f"{args.model_dir} has neither model_meta.json nor meta.json",
                  file=sys.stderr)
        else:
            print(f"error: {args.model_dir} has neither model_meta.json (trained directory) "
                  "nor meta.json (exported artifact)", file=sys.stderr)
        return 2
    if args.filter:
        return _serve_filter(args, ameta)
    from cbfssm_tpu_torch.serving_http import PredictionServer

    if ameta is not None:
        from cbfssm_tpu_torch.serving_http import ExportedBatchPredictor

        try:
            pred = ExportedBatchPredictor(args.model_dir, device=args.device)
        except (TypeError, ValueError, RuntimeError, FileNotFoundError) as e:
            # dict-predict artifact, platform or TF32 refusal, another kind
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        loaded = _load_checkpointed_model(args.model_dir, args.checkpoint, args.device)
        if loaded is None:
            return 2
        meta, model, params = loaded
        recipe = meta.get("dataset") or {}
        seq_len = args.seq_len or recipe.get("seq_len")
        if not seq_len:
            print("error: no dataset recipe in model_meta.json — pass --seq-len",
                  file=sys.stderr)
            return 2
        from cbfssm_tpu_torch.serving import BucketedPredictor

        try:
            pred = BucketedPredictor(model, params, int(seq_len), buckets=tuple(args.buckets),
                                     condition=args.condition)
        except (TypeError, ValueError) as e:
            # Voliro's dict predict, or invalid --buckets (e.g. empty)
            print(f"error: {e}", file=sys.stderr)
            return 2
    server = PredictionServer(pred, args.host, args.port, max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms,
                              auth_token=_resolve_auth_token(args))
    m = server.meta()
    banner = (f"serving {m['predictor']} (seq_len {m['seq_len']}, "
              f"dim_u {m['dim_u']}, dim_y {m['dim_y']}, {m['dtype']}, "
              f"auth {'on' if server.auth_token else 'off'}, {args.device}) "
              f"on http://{server.host}:{server.port}")
    return _serve_until_interrupt(server, banner)


def cmd_bench(_args) -> int:
    from cbfssm_tpu_torch import bench

    bench.main()
    return 0


def _add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model (default: cuda; 'cpu' for the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m cbfssm_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    i = sub.add_parser(
        "info",
        help="torch, CUDA, devices, model/dataset registry; with a model "
             "dir, describe its trained snapshot")
    i.add_argument("model_dir", nargs="?", default=None,
                   help="optional trained directory (model_meta.json) to describe instead")
    i.set_defaults(fn=cmd_info)

    r = sub.add_parser("reproduce", help="run a reproduction driver (cbfssm_tpu_torch.run_*)")
    r.add_argument("experiment", choices=sorted(DRIVERS))
    r.add_argument("--vmap-seeds", action="store_true",
                   help="train all iteration seeds as one lane-batched program")
    r.add_argument("--task", type=int, default=None,
                   help="small-scale task index (see run_smallscale.py)")
    r.add_argument("--root", default=None, help="output directory")
    r.add_argument("--data-dir", default=None,
                   help="directory holding the raw benchmark files")
    r.add_argument("--check-data", action="store_true",
                   help="validate the experiment's raw files (presence/keys/shapes) "
                        "and exit instead of training")
    r.add_argument("--epochs", type=int, default=None)
    r.add_argument("--iterations", type=int, default=None,
                   help="number of seeds/repetitions")
    r.add_argument("--train-iterations", type=int, default=None,
                   help="total optimizer steps (smallscale/spring scheme)")
    r.add_argument("--seq-len", type=int, default=None,
                   help="training window length (default: reference value)")
    r.add_argument("--seq-stride", type=int, default=None,
                   help="training window stride (default: reference value)")
    _add_device(r)
    r.set_defaults(fn=cmd_reproduce)

    e = sub.add_parser(
        "export",
        help="export a trained directory as an artifact (torch.export programs + params) "
             "that serve loads without the model classes")
    e.add_argument("model_dir",
                   help="directory written by a trainer (model_meta.json + checkpoints)")
    e.add_argument("--out", required=True, help="artifact directory to write")
    e.add_argument("--kind", choices=["predictor", "filter", "pool"], default="predictor")
    e.add_argument("--checkpoint", choices=["best", "last"], default="best")
    e.add_argument("--batch", type=int, default=1)
    e.add_argument("--seq-len", type=int, default=None,
                   help="predictor sequence length (predictor kind only)")
    e.add_argument("--condition", action="store_true",
                   help="export the conditioned predict path")
    e.add_argument("--horizons", type=int, nargs="*", default=[],
                   help="forecast horizons to export (filter/pool kinds)")
    e.add_argument("--replay-buckets", type=int, nargs="*", default=[],
                   help="backlog-replay chunk lengths to export (filter/pool kinds)")
    e.add_argument("--capacity", type=int, default=32,
                   help="fleet size baked into a pool artifact (pool kind only)")
    e.add_argument("--platforms", nargs="*", default=["cpu", "cuda"], choices=["cpu", "cuda"],
                   help="devices the artifact may be loaded on")
    _add_device(e)
    e.set_defaults(fn=cmd_export)

    v = sub.add_parser(
        "eval",
        help="re-evaluate a trained directory from disk alone (mse, "
             "calibration, prediction plots) — no producing script")
    v.add_argument("model_dir",
                   help="directory written by a trainer (model_meta.json + checkpoints)")
    v.add_argument("--out", default=None, help="artifact directory (default: the model dir)")
    v.add_argument("--checkpoint", choices=["best", "last"], default="best")
    v.add_argument("--dataset", default=None,
                   help="dataset class name (default: the recipe stamped by the trainer)")
    v.add_argument("--seq-len", type=int, default=None)
    v.add_argument("--seq-stride", type=int, default=None)
    v.add_argument("--data-dir", default=None,
                   help="directory holding the raw benchmark files")
    _add_device(v)
    v.set_defaults(fn=cmd_eval)

    s = sub.add_parser(
        "serve",
        help="serve prediction (or, with --filter, filter sessions) over HTTP "
             "(stdlib transport, coalescing) from a trained directory or an exported "
             "artifact")
    s.add_argument("model_dir",
                   help="trained directory (model_meta.json + checkpoints) or exported "
                        "artifact (meta.json)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8787, help="listen port (0 = ephemeral)")
    s.add_argument("--checkpoint", choices=["best", "last"], default="best")
    s.add_argument("--seq-len", type=int, default=None,
                   help="prediction window (default: the stamped dataset recipe)")
    s.add_argument("--buckets", type=int, nargs="*", default=[1, 8, 32],
                   help="batch-bucket ladder")
    s.add_argument("--condition", action="store_true",
                   help="serve the conditioned predict path")
    s.add_argument("--max-batch", type=int, default=32,
                   help="microbatcher coalescing bound")
    s.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="microbatcher coalescing window")
    s.add_argument("--filter", action="store_true",
                   help="serve online-estimation sessions (a FilterPool over a streaming "
                        "model's trained directory) instead of free-running prediction")
    s.add_argument("--capacity", type=int, default=None,
                   help="filter-session pool capacity (--filter only; default 32)")
    s.add_argument("--replay-buckets", type=int, nargs="*", default=None,
                   help="backlog-replay chunk ladder (--filter only)")
    s.add_argument("--auth-token", default=None,
                   help="shared-secret Bearer token required on every POST/DELETE and GET "
                        "/v1/state (default: CBFSSM_AUTH_TOKEN env var; unset = open — fine "
                        "for the loopback default, set one for any non-loopback bind)")
    _add_device(s)
    s.set_defaults(fn=cmd_serve)

    sub.add_parser("bench", help="headline ELBO steps/sec benchmark").set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
