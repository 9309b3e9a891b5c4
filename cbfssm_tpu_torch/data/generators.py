"""Offline synthetic-dataset simulators (port of
``cbfssm_tpu/data/generators.py``; numpy on the host): the RoboMove
robots and their return-to-origin policy, and the linear and nonlinear
spring systems, driven through :meth:`DSManager.sample_ds`
(``cbfssm_tpu_torch.create_datasets``).
"""

from __future__ import annotations

import math

import numpy as np


def _noise(dim, sigma, rng):
    if dim == 0:
        return np.zeros(0)
    return rng.multivariate_normal(np.zeros(dim), np.eye(dim) * sigma)


class RoboMoveDS:
    """2-D unicycle-like robot: state [pos_x, pos_y, orientation],
    control [speed, curvature]; measures position only."""

    def __init__(self, start_pos, start_orient, sigma_x, sigma_y, rng=None):
        start_pos = np.asarray(start_pos, dtype=np.float64)
        assert start_pos.shape == (2,)
        self.pos = start_pos
        self.orient = float(start_orient)
        self.sigma_x = sigma_x
        self.sigma_y = sigma_y
        self.rng = rng if rng is not None else np.random.default_rng()

    def get_state(self):
        return np.concatenate((self.pos, [self.orient]))

    def propagate_fn(self, x, u):
        pos = np.asarray(x[:2], dtype=np.float64).copy()
        orient = x[2]
        speed, curv = u[0], u[1]
        orient_vec = np.asarray([math.sin(orient), math.cos(orient)])
        if abs(curv) < 1e-5:
            pos += orient_vec * speed
        else:
            sign = np.sign(curv)
            normal = np.asarray([orient_vec[1], -orient_vec[0]]) * sign
            radius = 1.0 / abs(curv)
            angle = (speed / radius) * sign
            c, s = np.cos(angle), np.sin(angle)
            rot = np.asarray([[c, s], [-s, c]])
            pos += (normal - rot @ normal) * radius
            orient += angle
        pos += _noise(2, self.sigma_x, self.rng)
        orient = orient % (2.0 * math.pi)
        return np.concatenate((pos, [orient]))

    def propagate(self, u):
        x = self.propagate_fn(self.get_state(), u)
        self.pos = x[:2]
        self.orient = x[2]

    def measure(self):
        return self.pos + _noise(2, self.sigma_y, self.rng)

    @staticmethod
    def get_xdim():
        return 3


class RoboMoveSimpleDS:
    """As :class:`RoboMoveDS` but with a continuous orientation encoding
    (sin/cos) and full-state observation."""

    def __init__(self, start_pos, start_orient, sigma_x, sigma_y, rng=None):
        start_pos = np.asarray(start_pos, dtype=np.float64)
        assert start_pos.shape == (2,)
        self.pos = start_pos
        self.orient = np.asarray([math.sin(start_orient), math.cos(start_orient)])
        self.sigma_x = sigma_x
        self.sigma_y = sigma_y
        self.rng = rng if rng is not None else np.random.default_rng()

    def get_state(self):
        return np.concatenate((self.pos, self.orient))

    def propagate_fn(self, x, u):
        pos = np.asarray(x[:2], dtype=np.float64).copy()
        scale = math.hypot(x[2], x[3])
        orient_vec = np.asarray([x[2] / scale, x[3] / scale])
        speed, curv = u[0], u[1]
        if abs(curv) < 1e-5:
            pos += orient_vec * speed
            orient = orient_vec
        else:
            sign = np.sign(curv)
            normal = np.asarray([orient_vec[1], -orient_vec[0]]) * sign
            radius = 1.0 / abs(curv)
            angle = (speed / radius) * sign
            c, s = np.cos(angle), np.sin(angle)
            rot = np.asarray([[c, s], [-s, c]])
            pos += (normal - rot @ normal) * radius
            orient = rot @ orient_vec
        pos += _noise(2, self.sigma_x, self.rng)
        return np.concatenate((pos, orient))

    def propagate(self, u):
        x = self.propagate_fn(self.get_state(), u)
        self.pos = x[:2]
        self.orient = x[2:]

    def measure(self):
        return self.get_state() + _noise(4, self.sigma_y, self.rng)

    @staticmethod
    def get_xdim():
        return 4


class RoboMovePolicy:
    """Return-to-origin control policy: random exploration inside radius
    5, a decaying arc maneuver outside."""

    def __init__(self, rng=None):
        self.rng = rng if rng is not None else np.random.default_rng()
        self.state = 0
        self.val = np.zeros(2)
        self.ts = 0

    def _default(self):
        speed = max(0.0, self.rng.uniform(-0.1, 0.5))
        if self.rng.binomial(1, 0.3):
            curv = 0.0
        else:
            curv = self.rng.uniform(-1.5, 1.5)
        return np.asarray([speed, curv])

    def __call__(self, ts, x):
        x = np.asarray(x).ravel()
        dist = math.hypot(x[0], x[1])
        if dist < 5.0:
            self.state = 0
            return self._default()
        if self.state == 0:
            self.state = 1
            self.ts = ts
            speed = self.rng.uniform(0.2, 0.5)
            curv = self.rng.uniform(0.5, 0.8)
            sign = self.rng.binomial(1, 0.5) * 2.0 - 1.0
            self.val = np.asarray([speed, curv * sign])
        slow_down = 1.0 / (ts - self.ts + 1)
        return np.asarray([self.val[0], 0.8 * self.val[1] + 0.2 * slow_down * self.val[1]])


class LinearDS:
    """Linear-Gaussian state-space simulator x' = Ax + Bu + w, y = Cx + v.
    Vectors are 1-D arrays."""

    def __init__(self, a, b, c, q, r, x0, rng=None):
        self.a = np.asarray(a, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)
        self.c = np.asarray(c, dtype=np.float64)
        self.q = np.asarray(q, dtype=np.float64)
        self.r = np.asarray(r, dtype=np.float64)
        self.x = np.asarray(x0, dtype=np.float64).ravel()
        self.rng = rng if rng is not None else np.random.default_rng()

    def get_state(self):
        return self.x

    def propagate(self, u):
        u = np.asarray(u, dtype=np.float64).ravel()
        w = self.rng.multivariate_normal(np.zeros(self.x.shape[0]), self.q)
        self.x = self.a @ self.x + self.b @ u + w

    def measure(self):
        v = self.rng.multivariate_normal(np.zeros(self.c.shape[0]), self.r)
        return self.c @ self.x + v


class SpringNonlinearDS(LinearDS):
    """Spring-damper LTI system with a tanh input nonlinearity."""

    def propagate(self, u):
        super().propagate(np.tanh(np.asarray(u, dtype=np.float64) * 2.0))


def spring_nonlinear_system(b=0.05, k=1.0, m=0.002, dt=0.01):
    """The (A, B, C) matrices of the spring-damper system."""
    a = np.asarray([[1.0, dt, 0.0], [0.0, 1.0, dt], [-k / m, -b / m, 0.0]])
    b_mat = np.asarray([[0.0], [0.0], [1.0 / m]])
    c = np.asarray([[1.0, 0.0, 0.0]])
    return a, b_mat, c
