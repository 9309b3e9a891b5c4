"""Kernel events lost at the start of a ``torch.profiler`` trace on the card.

    python3 scripts/torch_trace_warmup.py

Builds ``chip_smoke.py``'s ``trainer_profile`` workload (CBFSSM at the
RoboMove width, float32, 'pallas', windows of 60 steps, 2 epochs of 2
Adam steps, epoch 1 traced through ``Trainer(profile_dir=)``) and runs
it 33 times in one process, three trace forms in turn, with phase 11's
cold compile (``chip_smoke.start_cold_compile``) loading the host from
round 2 on:

- A: one profiler cycle over the block (``utils.profiling.trace``
  before C11);
- B: a discarded warm-up cycle of 64 small kernels, a sync and 50 ms,
  then the block (``utils.profiling.trace`` now);
- C: the same prelude and sleep inside the one recorded cycle.

Prints one JSON line a trace: its ``gp_predict`` and kernel events,
the block's launch records without a kernel event (``block_missing``)
and the same for the prelude's. Needs the card.
"""
import contextlib, glob, json, os, sys, tempfile, time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs
import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule, tensorboard_trace_handler

card = cs.phase_device()
cs.phase_build()
from cbfssm_tpu_torch.data import RoboMove
from cbfssm_tpu_torch.models import CBFSSM
from cbfssm_tpu_torch.training import Trainer, trainer as trainer_mod

ds = RoboMove(cs.PROFILE_SEQ, cs.SEQ_STRIDE)
ds.train_in_batch, ds.train_out_batch = (a[:2 * cs.BATCH] for a in (ds.train_in_batch, ds.train_out_batch))
ds.test_in_batch, ds.test_out_batch = (a[:cs.BATCH] for a in (ds.test_in_batch, ds.test_out_batch))
model = CBFSSM(cs.config("float32", "pallas"), device="cuda")
ACT = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

def prelude(k=64):
    x = torch.zeros(1, device="cuda")
    with record_function("prelude"):
        for _ in range(k):
            x.add_(1)
        torch.cuda.synchronize()

def make(kind):
    @contextlib.contextmanager
    def tr(log_dir):
        os.makedirs(log_dir, exist_ok=True)
        h = tensorboard_trace_handler(log_dir)
        if kind == "A":
            with profile(activities=ACT, on_trace_ready=h) as prof:
                with record_function("block"):
                    yield prof
                torch.cuda.synchronize()
        elif kind == "B":
            with profile(activities=ACT, schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=h) as prof:
                prelude()
                time.sleep(0.05)
                prof.step()
                with record_function("block"):
                    yield prof
                torch.cuda.synchronize()
        elif kind == "C":
            with profile(activities=ACT, on_trace_ready=h) as prof:
                prelude()
                time.sleep(0.05)
                with record_function("block"):
                    yield prof
                torch.cuda.synchronize()
    return tr

T0 = time.time()
def run(kind, i):
    trainer_mod.trace = make(kind)
    with tempfile.TemporaryDirectory(dir=cs.ROOT / "build") as root:
        log_dir = os.path.join(root, "trace")
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            Trainer(model, os.path.join(root, "a"), seed=0, profile_dir=log_dir).train(ds, epochs=2)
        f, = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        doc = json.load(open(f))
    ev = doc["traceEvents"]
    ann = {e["name"]: e for e in ev if e.get("cat") == "user_annotation"}
    b0, b1 = ann["block"]["ts"], ann["block"]["ts"] + ann["block"]["dur"]
    kern = [e for e in ev if e.get("cat") == "kernel"]
    kc = {e["args"].get("correlation") for e in kern}
    launches = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver") and "aunch" in e.get("name", "")]
    blk = [l for l in launches if b0 <= l["ts"] <= b1]
    pre = [l for l in launches if l["ts"] < b0]
    gp = sum("gp_predict" in e.get("name", "") for e in kern)
    print(json.dumps({"kind": kind, "i": i, "t": round(time.time() - T0, 1), "gp": gp, "kernels": len(kern),
        "block_launches": len(blk), "block_missing": sum(l["args"].get("correlation") not in kc for l in blk),
        "pre_launches": len(pre), "pre_missing": sum(l["args"].get("correlation") not in kc for l in pre)}), flush=True)

cold = None
for i in range(11):
    if i == 2:
        cold = cs.start_cold_compile(card)
    for kind in "ABC":
        run(kind, i)
cold["proc"].kill()
