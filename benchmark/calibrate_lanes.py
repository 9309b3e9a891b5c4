"""The readings the limits of ``correct`` are set from, for a lane cell
(a traffic file with ``"mix": "lanes"``), on the card, in one process:

    python3 benchmark/calibrate_lanes.py --workload sarcos-lanes --seeds 11,12,13,14,15 \
        --control 11,12,13 --faults 11,12,13 --out build/calibrate_lanes.json

For every seed of ``--seeds``: the lane program's first steps (set-up's
``MultiSeedTrainer.train`` up to the checked steps, no window) against
the float64 reference, the worst lane of each number: the lower
readings. For the seeds of ``--control``: the reference computed in
float32 with TF32 matmuls in the program's place (the control), and in
plain float32 (for comparison). For the seeds of ``--faults``: the
program with each fault of :mod:`benchmark.lane_faults` planted (half
of each batch left out, the state handed back unchanged, two lanes'
draws swapped). Writes every reading, with each lane's, as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


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

    from benchmark import harness, lane_faults
    from benchmark.mixes import lanes, train
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
        run = lanes.Run(cell, seed, args.device)
        run.make_inputs()
        program = run.setup(steps_only=True)
        run.free_program()
        t1 = time.perf_counter()
        ref = run.reference(f64)
        t2 = time.perf_counter()
        rec["program"] = lanes.compare(program, ref)
        rec["program_lanes"] = [train.compare(p, r) for p, r in zip(program, ref)]
        rec["losses"] = {"program": [p["losses"] for p in program],
                         "reference": [r["losses"] for r in ref]}
        rec["seconds"] = {"program": t1 - t0, "reference": t2 - t1}
        if seed in ints(args.control):
            ctl = run.reference(common.Precision(torch.float32, tf32=True))
            rec["control_tf32"] = lanes.compare(ctl, ref)
            rec["reference_f32"] = lanes.compare(
                run.reference(common.Precision(torch.float32)), ref)
        if seed in ints(args.faults):
            for name, fault in lane_faults.FAULTS.items():
                with lane_faults.planted(fault):
                    program = run.setup(steps_only=True)
                run.free_program()
                rec[name] = lanes.compare(program, ref)
        run.close()
        out["seeds"][seed] = rec
        print(json.dumps({seed: {k: v for k, v in rec.items() if k not in (
            "losses", "program_lanes")}}), file=sys.stderr, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
