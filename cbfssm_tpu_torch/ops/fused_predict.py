"""Fused sparse-GP predict: the CUDA kernel ``csrc/gp_predict.cu`` and
its plain torch version.

Port of ``cbfssm_tpu/ops/pallas/gp_predict.py`` (``_kernel`` and
``_reference_forward``). :func:`fused_predict` dispatches on the device
of its input: a CPU tensor takes :func:`fused_predict_plain`; a CUDA
float32/float64 tensor launches the kernel; anything else raises. There
is no fallback from the kernel to the plain version: a build or launch
failure raises. (The JAX package instead runs its jnp math on every
backend but the TPU.)

The kernel is built with ``nvcc`` at the first CUDA call
(:mod:`cbfssm_tpu_torch.ops._build`), never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cbfssm_tpu_torch.ops import _build


def fused_predict_plain(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    """Sparse-GP predictive (mean, var) in torch ops: the counterpart of
    ``_reference_forward`` and the kernel's reference."""
    xs = x * inv_ls
    xn = torch.sum(torch.square(xs), dim=-1, keepdim=True)
    zn = torch.sum(torch.square(zs), dim=-1)[None, :]
    d2 = torch.clamp_min(xn - 2.0 * torch.matmul(xs, zs.T) + zn, 0.0)
    kmn = kvar * torch.exp(-0.5 * d2)
    w = torch.matmul(kmn, kinv)
    qf = torch.sum(kmn * w, dim=-1, keepdim=True)
    mean = torch.matmul(kmn, alpha)
    var = torch.clamp_min(kvar - qf, 0.0) + torch.matmul(torch.square(w), var_q)
    return mean, var


@functools.cache
def _library():
    """The built kernel library with its C signatures declared: nine
    pointers, four ints (n, m, di, d) and the stream."""
    lib = _build.load("gp_predict")
    for fn in (lib.gp_predict_f32, lib.gp_predict_f64):
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.gp_predict_error_string.argtypes = [ctypes.c_int]
    lib.gp_predict_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    n, di = x.shape
    m, d = zs.shape[0], alpha.shape[-1]
    want = {
        "zs": (zs, (m, di)), "inv_ls": (inv_ls, (di,)), "kvar": (kvar, ()),
        "kinv": (kinv, (m, m)), "alpha": (alpha, (m, d)), "var_q": (var_q, (m, d)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_predict: {name} must be {list(shape)}, got {list(t.shape)}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"fused_predict: {name} is {t.dtype} on {t.device}, x is {x.dtype} on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_predict: {name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("fused_predict: x must be contiguous")
    return n, m, di, d


def fused_predict(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    """Sparse-GP predictive (mean [N, D], var [N, D]) at x.

    x: [N, DI] query points; zs: [M, DI] inducing inputs times inv_ls;
    inv_ls: [DI]; kvar: [] kernel variance; kinv: [M, M] inverse of the
    jittered Gram; alpha: [M, D] kinv @ variational mean; var_q: [M, D]
    variational variances. All on one device, in one dtype, contiguous.

    ``fused_predict.launches`` counts kernel launches (CUDA calls only).
    """
    if x.dim() != 2:
        raise ValueError(f"fused_predict: x must be [N, DI], got {list(x.shape)}")
    n, m, di, d = _check(x, zs, inv_ls, kvar, kinv, alpha, var_q)
    if x.device.type == "cpu":
        return fused_predict_plain(x, zs, inv_ls, kvar, kinv, alpha, var_q)
    if x.device.type != "cuda":
        raise ValueError(f"fused_predict: no kernel for device {x.device}")
    if x.dtype == torch.float32:
        entry = "gp_predict_f32"
    elif x.dtype == torch.float64:
        entry = "gp_predict_f64"
    else:
        raise ValueError(f"fused_predict: the kernel takes float32 or float64, got {x.dtype}")
    mean = torch.empty((n, d), dtype=x.dtype, device=x.device)
    var = torch.empty((n, d), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), zs.data_ptr(), inv_ls.data_ptr(), kvar.data_ptr(),
            kinv.data_ptr(), alpha.data_ptr(), var_q.data_ptr(),
            mean.data_ptr(), var.data_ptr(), n, m, di, d, stream,
        )
    if err != 0:
        msg = lib.gp_predict_error_string(err).decode()
        raise RuntimeError(
            f"gp_predict kernel launch failed ({err}: {msg}) at N={n} M={m} DI={di} D={d}"
        )
    fused_predict.launches += 1
    return mean, var


fused_predict.launches = 0
