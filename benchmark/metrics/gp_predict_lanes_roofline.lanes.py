"""Share of its roofline the lane GP-predict kernels reach: the least
time of the traced span's lane predictions (L x the frozen bound of
each shape a train step and a test batch launch, from the
configuration's ``gp_predict``, whose ``l`` is L) over the summed device
time of the kernels whose name holds ``gp_predict['kernel']``. The
launches traced must be the ones the configuration reckons for the
span's steps and test batches, and the ones the program counted over
the span (``lane_launches``)."""

from benchmark.yardstick import gp_predict_bound


def read(summary):
    if not summary.get("busy_s"):
        return None
    gp, dtype = summary["cfg"]["gp_predict"], summary["cfg"]["model"]["dtype"]
    hits = [v for name, v in summary["device_ops_by_name"].items() if gp["kernel"] in name]
    launches, seconds = sum(v[0] for v in hits), sum(v[1] for v in hits)
    counts = {"train_step": summary["train_steps"], "eval_batch": summary["eval_batches"]}
    want, least = 0, 0.0
    for part, times in counts.items():
        for s in gp[part]:
            want += times * s["count"]
            least += times * s["count"] * int(gp["l"]) * gp_predict_bound(
                s["n"], s["m"], s["di"], s["d"], dtype, s["residuals"])[0]
    if launches != want or summary.get("lane_launches", launches) != launches:
        raise RuntimeError(f"traced {launches} lane GP-predict launches, the configuration "
                           f"reckons {want} for {counts}, the program counted "
                           f"{summary.get('lane_launches')}")
    return 100.0 * least / seconds if seconds > 0 else None
