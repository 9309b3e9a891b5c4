"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload robomove-train --seed 7 --seconds 30 --trace 0

From the root of a checkout. Set-up (data, weights, the program's
trainer and its first steps), the measured window, the check against
the plain reference, then one JSON object as the last line of standard
output, and the numbers compared, each beside its limit, as the last
lines of standard error. It exits non-zero, printing no result, when
the card is missing, the cell asks for more cards than there are, the
program cannot be imported, or a module of JAX or of the JAX package
was loaded. The program's caches stay inside the checkout
(``build/benchmark_cache``); its CUDA kernel is built into
``build/cbfssm_tpu_torch`` by its first run there.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "benchmark_cache"
for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton"),
                 ("CBFSSM_XLA_CACHE", "compile")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host issues the card's work from one
# Python thread, and idle OpenMP / MKL pools only add noise to its clock
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    chips = int(harness.Cell(args.workload).workload["chips"])
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible",
              file=sys.stderr)
        return 2
    result = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}", file=sys.stderr)
        return 3
    for c in result["checks"].values():  # strict JSON has no infinity
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
