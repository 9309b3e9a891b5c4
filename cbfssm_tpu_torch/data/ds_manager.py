"""``.mat`` dataset manager and rollout samplers (port of
``cbfssm_tpu/data/ds_manager.py``; numpy only).

Convention: ``x[i+1] = f(x[i], u[i])``, ``y[i] = g(x[i])``; arrays are
2-D ``[ds_size, dim]``; files store keys ``ds_u / ds_x / ds_y / title``.
"""

from __future__ import annotations

import numpy as np
import scipy.io


class DSManager:
    @staticmethod
    def load_ds(filename, normalize=False, print_title=True, dtype=np.float64):
        """(u, x, y) arrays of one ``.mat`` file in ``dtype``, each
        z-scored over time when ``normalize``."""
        ds = scipy.io.loadmat(filename)
        if print_title:
            print("Loaded Dataset " + "".join(ds["title"]))
        u, x, y = (ds[k].astype(dtype) for k in ("ds_u", "ds_x", "ds_y"))
        if normalize:
            u, x, y = (DSManager.normalize_ds(a) for a in (u, x, y))
        return u, x, y

    @staticmethod
    def save_ds(filename, u, x, y, title, dtype=np.float64):
        """Write (u, x, y), equal-length 2-D arrays, and ``title``."""
        if not (u.ndim == 2 and x.ndim == 2 and y.ndim == 2):
            raise ValueError(f"u, x, y must be 2-D, got {u.shape}, {x.shape}, {y.shape}")
        if not u.shape[0] == x.shape[0] == y.shape[0]:
            raise ValueError(f"u, x, y lengths differ: {u.shape[0]}, {x.shape[0]}, {y.shape[0]}")
        scipy.io.savemat(
            filename,
            {"ds_u": u.astype(dtype), "ds_x": x.astype(dtype), "ds_y": y.astype(dtype),
             "title": title},
        )

    @staticmethod
    def sample_ds(sim, ds_size, u_fn):
        """Roll out ``sim`` for ``ds_size`` steps driven by the policy
        ``u_fn(step, state)``; returns (u, x, y) arrays."""
        u_all, x_all, y_all = [], [], []
        for i in range(ds_size):
            x = sim.get_state()
            x_all.append(np.asarray(x).ravel())
            y_all.append(np.asarray(sim.measure()).ravel())
            u = u_fn(i, x)
            u_all.append(np.asarray(u).ravel())
            sim.propagate(u)
        return np.asarray(u_all), np.asarray(x_all), np.asarray(y_all)

    @staticmethod
    def sample_ds_matrix(sim, ds_size, u_fn):
        """Rollout sampler for simulators that speak column vectors:
        states, measurements and controls are ``[d, 1]`` columns; rows
        are taken through the transpose and the columns themselves flow
        to ``u_fn`` / ``propagate`` untouched."""
        u_all, x_all, y_all = [], [], []
        for i in range(ds_size):
            x = sim.get_state()
            x_all.append(np.asarray(x.T)[0, :])
            y_all.append(np.asarray(sim.measure().T)[0, :])
            u = u_fn(i, x)
            u_all.append(np.asarray(u.T)[0, :])
            sim.propagate(u)
        return np.asarray(u_all), np.asarray(x_all), np.asarray(y_all)

    @staticmethod
    def normalize_ds(data):
        """Zero mean, unit standard deviation over the first axis."""
        ret = data - np.mean(data, axis=0)
        return ret / np.std(ret, axis=0)
