"""The card's peaks and the least time of a GP prediction.

Peaks of one NVIDIA H100 SXM 80 GB at its 700 W limit, dense rates, as
NVIDIA's H100 Tensor Core GPU data sheet publishes them: 67 TFLOP/s
float32 and 34 TFLOP/s float64 on the CUDA cores, 495 TFLOP/s TF32 and
67 TFLOP/s float64 on the tensor cores, 3.35 TB/s of HBM3.

:func:`gp_predict_bound` is a frozen copy of ``chip_smoke.bound`` as it
stood when the fused kernels ran their product on the tensor cores
(3xTF32 for float32, so a third of TF32's rate; DMMA for float64).
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # CUDA cores
PEAK_TC = {"float32": 495e12 / 3, "float64": 67e12}  # the product's tensor-core rate
PEAK_BYTES = 3.35e12
PEAK_SOURCE = "NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB, dense, 700 W"


def gp_predict_bound(n, m, di, d, dtype: str, residuals: bool) -> tuple:
    """(seconds, 'operations' | 'bytes'): the least time the card could
    take for one prediction of ``n`` rows against ``m`` inducing points
    (``di`` inputs, ``d`` outputs). Operations per row: the product
    [w | mean] = kmn @ [kinv | alpha], 2 M (M + D), at the tensor-core
    rate, and at the CUDA-core rate the cross-Gram 2 M DI, the variance
    product 2 M D, the M-long epilogues (~9 M) and 3 DI, the two times
    summed. Bytes: each input read once, each output written once (with
    residuals also kmn and w, [N, M] each)."""
    itemsize = 4 if dtype == "float32" else 8
    tc_ops = n * 2 * m * (m + d)
    ops = n * (2 * m * di + 2 * m * d + 9 * m + 3 * di)
    elems = n * di + m * di + di + 1 + m * m + 2 * m * d + 2 * n * d
    if residuals:
        elems += 2 * n * m
    t_ops = tc_ops / PEAK_TC[dtype] + ops / PEAK_FLOPS[dtype]
    t_bytes = elems * itemsize / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
