"""Generate the nonlinear spring-damper dataset (port of
``create_datasets/create_spring_nonlinear.py``, with the same flags): a
10000-step rollout of the 3-state LTI spring with a tanh input
nonlinearity, driven by piecewise-constant random inputs.

    python -m cbfssm_tpu_torch.create_datasets.create_spring_nonlinear --seed 0
"""

import argparse
import math

import numpy as np

from cbfssm_tpu_torch.data.ds_manager import DSManager
from cbfssm_tpu_torch.data.generators import SpringNonlinearDS, spring_nonlinear_system


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=10000)
    parser.add_argument("--out", type=str, default="spring_nonlinear.mat")
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args()

    b, k, m, dt = 0.05, 1.0, 0.002, 0.01
    sigma_x, sigma_y = 0.0, 1e-4
    rng = np.random.default_rng(args.seed)
    ds_size = args.size

    a_mat, b_mat, c_mat = spring_nonlinear_system(b=b, k=k, m=m, dt=dt)
    q = np.eye(3) * sigma_x
    r = np.eye(1) * sigma_y
    x0 = np.asarray([1.0, 0.0, 0.0])

    # at least one interval: --size < 100 would make this empty and
    # crash the first u_fn lookup
    rand_int = rng.uniform(low=-2, high=2, size=max(1, ds_size // 100))

    def u_fn(ts, _):
        return np.asarray([rand_int[math.floor(ts / ds_size * len(rand_int))]])

    sim = SpringNonlinearDS(a_mat, b_mat, c_mat, q, r, x0, rng=rng)
    for _ in range(5):
        sim.propagate(u_fn(0, 0))

    u_all, x_all, y_all = DSManager.sample_ds(sim, ds_size, u_fn)
    title = (
        f"Spring-Nonlinear-b{b}-k{k}-m{m}-dt{dt}-sx{sigma_x}-sy{sigma_y}-u_randint"
    )
    DSManager.save_ds(args.out, u_all, x_all, y_all, title)
    print("Saved " + title)


if __name__ == "__main__":
    main()
