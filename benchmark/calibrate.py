"""The readings the limits of ``correct`` are set from, for one cell, on
the card, in one process:

    python3 benchmark/calibrate.py --workload robomove-train --seeds 11,12,13 \
        --control 11,12,13 --faults 11,12,13 --out build/calibrate.json

For every seed of ``--seeds``: the program's first steps (set-up's
``Trainer.train`` up to the checked steps, no window) against the
float64 reference: the lower readings. For the seeds of ``--control``:
the reference computed in float32 with TF32 matmuls in the program's
place (the control), and in plain float32 (for comparison). For the
seeds of ``--faults``: the program with half of each batch left out and
the mean taken over the rest. A step that returns its state unchanged
reads 1 on ``grad`` and ``change`` by construction and needs no run.
Writes every reading, with each leaf's, as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def leaf_norms(a, b):
    """[[program norm, reference norm], ...], a pair for each leaf."""
    import torch

    return [[float(torch.linalg.vector_norm(x)), float(torch.linalg.vector_norm(y))]
            for x, y in zip(a, b)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from benchmark import faults, harness
    from benchmark.mixes import train
    from benchmark.reference import common

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = harness.Cell(args.workload)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"workload": args.workload, "card": harness.power_limit(), "seeds": {}}
    f64 = common.Precision(torch.float64)
    for seed in ints(args.seeds):
        rec = {}
        t0 = time.perf_counter()
        run = train.Run(cell, seed, args.device)
        run.make_inputs()
        program = run.setup(steps_only=True)
        run.free_program()
        t1 = time.perf_counter()
        ref = run.reference(f64)
        t2 = time.perf_counter()
        rec["program"] = train.compare(program, ref)
        rec["losses"] = {"program": program["losses"], "reference": ref["losses"]}
        rec["grad_norms"] = leaf_norms(program["grad"], ref["grad"])
        rec["change_norms"] = leaf_norms(program["change"], ref["change"])
        rec["seconds"] = {"program": t1 - t0, "reference": t2 - t1}
        if seed in ints(args.control):
            ctl = run.reference(common.Precision(torch.float32, tf32=True))
            rec["control_tf32"] = train.compare(ctl, ref)
            rec["control_tf32_losses"] = ctl["losses"]
            rec["reference_f32"] = train.compare(run.reference(common.Precision(torch.float32)),
                                                   ref)
        if seed in ints(args.faults):
            with faults.planted(faults.half_batch):
                program = run.setup(steps_only=True)
            run.free_program()
            rec["half_batch"] = train.compare(program, ref)
        run.close()
        out["seeds"][seed] = rec
        print(json.dumps({seed: {k: rec[k] for k in rec if k in (
            "program", "control_tf32", "reference_f32", "half_batch", "seconds")}}),
            file=sys.stderr, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
