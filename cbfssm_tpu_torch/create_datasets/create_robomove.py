"""Generate the RoboMove synthetic datasets (port of
``create_datasets/create_robomove.py``, with the same flags): a
30000-step rollout of the 2-D robot under the return-to-origin policy.
By default it writes the full-observation 'simple' variant; ``--partial``
writes the partially observed one (robomove.mat).

    python -m cbfssm_tpu_torch.create_datasets.create_robomove --partial --seed 0
"""

import argparse

import numpy as np

from cbfssm_tpu_torch.data.ds_manager import DSManager
from cbfssm_tpu_torch.data.generators import RoboMoveDS, RoboMovePolicy, RoboMoveSimpleDS


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--partial", action="store_true", help="partial observation variant")
    parser.add_argument("--size", type=int, default=30000)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args()

    sigma_x, sigma_y = 1e-5, 1e-4
    rng = np.random.default_rng(args.seed)
    if args.partial:
        sim = RoboMoveDS(np.zeros(2), 0.0, sigma_x, sigma_y, rng=rng)
        path = args.out or "robomove.mat"
        title = f"RoboMove-sx{sigma_x}-sy{sigma_y}"
    else:
        sim = RoboMoveSimpleDS(np.zeros(2), 0.0, sigma_x, sigma_y, rng=rng)
        path = args.out or "robomove_simple.mat"
        title = f"RoboMoveSimple-sx{sigma_x}-sy{sigma_y}"

    policy = RoboMovePolicy(rng=rng)
    u_all, x_all, y_all = DSManager.sample_ds(sim, args.size, policy)
    DSManager.save_ds(path, u_all, x_all, y_all, title)
    print("Saved " + title)


if __name__ == "__main__":
    main()
