"""Synthetic raw data files under the real file names, made from a seed.

The Voliro flight logs (``voliro_tilt.mat``, ``voliro_flip.mat``) and
the system-identification files (``actuator.mat``, ``ballbeam.dat``,
``drive.mat``, ``dryer.dat``, ``gas_furnace.csv``, ``sarcos_inv.mat``)
are not in the repository. These writers stage files of the same layout
and size, so that the datasets, drivers and ``chip_smoke.py`` run end to
end at the configs' widths:

    python -m cbfssm_tpu_torch.data.synthetic DIR [--seed 0]
    python -c "from cbfssm_tpu_torch import run_voliro; run_voliro.main(data_dir='DIR')"

The numbers mean nothing physical: the flight log is a smooth sinusoid
trajectory with valid attitude quaternions and uniform rotor commands;
the system-identification files are standard-normal noise.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io

from cbfssm_tpu_torch.data.voliro_loader import _LOG_KEYS
from cbfssm_tpu_torch.utils import rotations

# (file, rows) of the system-identification tasks: each longer than its
# published split point; Sarcos is 66 experiments of 674 samples.
SYSID_ROWS = {"actuator.mat": 1024, "drive.mat": 500, "ballbeam.dat": 1000,
              "dryer.dat": 1000, "gas_furnace.csv": 296, "sarcos_inv.mat": 66 * 674}
# the crops of VoliroDS need 3,801 tilt and 20,173 flip samples
VOLIRO_LOGS = {"voliro_tilt.mat": (4000, 1), "voliro_flip.mat": (20500, 2)}


def voliro_log(path, n=600, seed=0):
    """A PX4-style flight log of ``n`` samples, every key an (n, 1) array
    inside a ``dataset`` struct: the time in microseconds (dt 0.01 s),
    a smooth position, a slowly turning attitude, uniform PWM and tilt
    commands and a battery voltage. The draws follow the JAX package's
    test fixture (tests/test_voliro_dataset.py ``make_log``), which also
    draws two PWM channels per rotor that the loader does not read."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    data = {
        "TIME_StartTime": t * 10_000.0,
        "LPOS_X": np.sin(t * 0.01),
        "LPOS_Y": np.cos(t * 0.013),
        "LPOS_Z": -1.0 + 0.1 * np.sin(t * 0.007),
    }
    q = rotations.quaternion_from_euler(0.2 * np.sin(t * 0.01), 0.1 * np.sin(t * 0.008),
                                        0.3 + 0.05 * t * 0.001)
    for i, k in enumerate(("ATT_qw", "ATT_qx", "ATT_qy", "ATT_qz")):
        data[k] = q[:, i]
    for j in range(6):
        rng.uniform(0.3, 0.9, n)  # OUT0_Out{j+2}, not read
        rng.uniform(0.3, 0.9, n)  # OUT1_Out{j}, not read
        data[f"ATC0_Out{j}"] = rng.uniform(0.4, 0.8, n)
        data[f"ATC1_Out{j}"] = rng.uniform(0.4, 0.8, n)
        data[f"ATC2_Out{j}"] = rng.uniform(-0.5, 0.5, n)
    data["BATT_VFilt"] = 15.0 + 0.1 * np.sin(t * 0.002)
    scipy.io.savemat(path, {"dataset": {k: data[k].reshape(-1, 1) for k in _LOG_KEYS}})


def sysid_files(data_dir, seed=0, names=None):
    """The raw files of the system-identification tasks (``names``, by
    default all six) in ``data_dir``, standard-normal values from
    ``seed``, with each file's layout: ``.mat`` keys (u, p), (u1, z1),
    ``sarcos_inv`` [rows, 28]; two-column text for the ``.dat`` files; a
    CSV with a header line for the furnace."""
    rng = np.random.default_rng(seed)
    for name in names or SYSID_ROWS:
        rows, path = SYSID_ROWS[name], os.path.join(data_dir, name)
        if name == "actuator.mat":
            scipy.io.savemat(path, {"u": rng.normal(size=(rows, 1)),
                                    "p": rng.normal(size=(rows, 1))})
        elif name == "drive.mat":
            scipy.io.savemat(path, {"u1": rng.normal(size=(rows, 1)),
                                    "z1": rng.normal(size=(rows, 1))})
        elif name == "sarcos_inv.mat":
            scipy.io.savemat(path, {"sarcos_inv": rng.normal(size=(rows, 28))})
        elif name == "gas_furnace.csv":
            np.savetxt(path, rng.normal(size=(rows, 2)), delimiter=",", header="u,y",
                       comments="")
        else:
            np.savetxt(path, rng.normal(size=(rows, 2)))


def stage_all(data_dir, seed=0):
    """Both Voliro logs (seeds ``seed + 1`` and ``seed + 2``) and every
    system-identification file in ``data_dir``."""
    os.makedirs(data_dir, exist_ok=True)
    for name, (n, offset) in VOLIRO_LOGS.items():
        voliro_log(os.path.join(data_dir, name), n=n, seed=seed + offset)
    sysid_files(data_dir, seed)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("data_dir")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    stage_all(args.data_dir, args.seed)
    print(f"staged {', '.join([*VOLIRO_LOGS, *SYSID_ROWS])} in {args.data_dir}")


if __name__ == "__main__":
    main()
