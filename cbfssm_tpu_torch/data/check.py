"""Raw-benchmark-file validation for the reproduction drivers (port of
``cbfssm_tpu/data/check.py``).

The real benchmark files (Actuator/Sarcos/... .mat/.dat/.csv files,
Voliro flight logs) are not shipped; when a user stages them,
``python -m cbfssm_tpu_torch reproduce <x> --check-data`` runs these
validators (presence, parseability, keys, shapes, and the loaders' own
consistency checks) and reports a table instead of failing deep inside
windowing or a training step. The ``.mat`` files are read with scipy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class CheckResult:
    file: str
    ok: bool
    detail: str


def _default_dir() -> str:
    from cbfssm_tpu_torch.data.base import DEFAULT_DATA_DIR

    return str(DEFAULT_DATA_DIR)


def _check_dsmanager_file(data_dir, filename, dim_u, dim_y, min_len):
    from cbfssm_tpu_torch.data.ds_manager import DSManager

    path = os.path.join(data_dir, filename)
    if not os.path.isfile(path):
        return CheckResult(filename, False, "missing")
    try:
        u, x, y = DSManager.load_ds(path, print_title=False)
    except Exception as exc:
        return CheckResult(filename, False, f"unreadable: {exc}")
    if u.shape[1] != dim_u or y.shape[1] != dim_y:
        return CheckResult(
            filename, False,
            f"dims (u{u.shape[1]}, y{y.shape[1]}) != expected "
            f"(u{dim_u}, y{dim_y})",
        )
    if not (len(u) == len(x) == len(y)):
        return CheckResult(filename, False, "u/x/y length mismatch")
    if len(u) < min_len:
        return CheckResult(
            filename, False, f"only {len(u)} samples (< {min_len})"
        )
    return CheckResult(
        filename, True, f"{len(u)} samples, u{u.shape[1]} y{y.shape[1]}"
    )


def _check_task(data_dir, task_name, filename, dim_u, dim_y):
    from cbfssm_tpu_torch.data.system_id_tasks import TASK_LOADERS, validate_task

    path = os.path.join(data_dir, filename)
    if not os.path.isfile(path):
        return CheckResult(filename, False, "missing")
    try:
        task = validate_task(TASK_LOADERS[task_name](data_dir), task_name)
    except Exception as exc:
        return CheckResult(filename, False, f"invalid: {exc}")
    got_u = task.train_in[0].shape[1]
    got_y = task.train_out[0].shape[1]
    if (got_u, got_y) != (dim_u, dim_y):
        return CheckResult(
            filename, False,
            f"dims (u{got_u}, y{got_y}) != expected (u{dim_u}, y{dim_y})",
        )
    n_tr = sum(len(e) for e in task.train_in)
    n_te = sum(len(e) for e in task.test_in)
    return CheckResult(
        filename, True,
        f"{len(task.train_in)}+{len(task.test_in)} experiments, "
        f"{n_tr}+{n_te} samples",
    )


def _check_voliro_log(data_dir, filename, end_idx):
    import scipy.io

    from cbfssm_tpu_torch.data.voliro_loader import _LOG_KEYS

    path = os.path.join(data_dir, filename)
    if not os.path.isfile(path):
        return CheckResult(filename, False, "missing")
    try:
        raw = scipy.io.loadmat(path)
    except Exception as exc:
        return CheckResult(filename, False, f"unreadable: {exc}")
    if "dataset" not in raw:
        return CheckResult(filename, False, "no 'dataset' struct in .mat")
    fields = set(raw["dataset"].dtype.names or ())
    missing = [k for k in _LOG_KEYS if k not in fields]
    if missing:
        return CheckResult(
            filename, False, f"log keys missing: {missing[:4]}..."
        )
    try:
        n = len(raw["dataset"]["TIME_StartTime"][0][0].T[0])
    except Exception as exc:
        return CheckResult(filename, False, f"malformed TIME channel: {exc}")
    if n <= end_idx:
        # the loader reads t[end_idx] itself for dt (voliro_loader.py),
        # so exactly end_idx rows still fails: require end_idx + 1
        return CheckResult(
            filename, False,
            f"{n} log rows <= {end_idx} (the reference crop range reads "
            f"index {end_idx})",
        )
    return CheckResult(filename, True, f"{n} log rows, all {len(_LOG_KEYS)} keys")


def check_experiment(experiment: str, data_dir: str | None = None):
    """Validate every raw file the named reproduction driver reads.

    Returns a list of :class:`CheckResult` (one per required file).
    """
    data_dir = data_dir or _default_dir()
    # min_len = split + the driver's seq_len: the test split must hold
    # at least one full window or rnn_batches asserts deep in windowing
    # (spring: split 5000, seq 50; robomove: split 25000, seq 300)
    if experiment == "spring":
        return [
            _check_dsmanager_file(data_dir, "spring_nonlinear.mat", 1, 1, 5050)
        ]
    if experiment == "robomove":
        return [_check_dsmanager_file(data_dir, "robomove.mat", 2, 2, 25300)]
    if experiment == "smallscale":
        return [
            _check_task(data_dir, name, fname, 1, 1)
            for name, fname in (
                ("actuator", "actuator.mat"),
                ("ballbeam", "ballbeam.dat"),
                ("drive", "drive.mat"),
                ("furnace", "gas_furnace.csv"),
                ("dryer", "dryer.dat"),
            )
        ]
    if experiment == "sarcos":
        return [_check_task(data_dir, "sarcos", "sarcos_inv.mat", 7, 7)]
    if experiment == "voliro":
        # reference crop ranges: tilt 1500:3800, flip 17600:20172
        return [
            _check_voliro_log(data_dir, "voliro_tilt.mat", 3800),
            _check_voliro_log(data_dir, "voliro_flip.mat", 20172),
        ]
    raise ValueError(f"unknown experiment: {experiment!r}")


def report(results) -> bool:
    """Print a status table; True iff every file checks out."""
    width = max(len(r.file) for r in results)
    for r in results:
        mark = "OK " if r.ok else "FAIL"
        print(f"  {mark} {r.file:<{width}}  {r.detail}")
    return all(r.ok for r in results)
