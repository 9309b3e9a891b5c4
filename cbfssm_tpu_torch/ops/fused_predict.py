"""Fused sparse-GP predict: the CUDA kernels of ``csrc/gp_predict.cu``,
their plain torch versions, and the analytic backward.

Port of ``cbfssm_tpu/ops/pallas/gp_predict.py``:

- :func:`fused_predict_plain` / :func:`fused_predict_residuals_plain`
  are ``_reference_forward`` (the second also returns the residuals
  ``(xs, kmn, w)``);
- the wrappers :func:`fused_predict` (kernel ``_kernel``) and
  :func:`fused_predict_residuals` (kernel ``_kernel_with_residuals``)
  dispatch on the device of their input: a CPU tensor takes the plain
  version; a CUDA float32/float64 tensor launches the kernel; anything
  else raises. There is no fallback from a kernel to the plain version:
  a build or launch failure raises. (The JAX package instead runs its
  jnp math on every backend but the TPU.) N = 0 rows give empty outputs
  without a launch. All of kinv is staged in shared memory, so M is
  capped (:func:`max_inducing_points`); a larger M raises before the
  launch.
- :func:`fused_predict_bwd` is the analytic VJP ``_bwd``, in torch ops,
  and :class:`FusedPredict` the ``torch.autograd.Function`` that pairs
  it with the residual-emitting forward, as ``jax.custom_vjp`` pairs
  ``_fwd`` and ``_bwd``. Like the custom VJP, it is used on every
  device: CPU gradients come from :func:`fused_predict_bwd` too.

The kernels are built with ``nvcc`` at the first CUDA call
(:mod:`cbfssm_tpu_torch.ops._build`), never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from cbfssm_tpu_torch.ops import _build


def fused_predict_residuals_plain(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    """Sparse-GP predictive in torch ops: ``(mean, var, (xs, kmn, w))``,
    the counterpart of ``_reference_forward`` and the kernels' reference."""
    xs = x * inv_ls
    xn = torch.sum(torch.square(xs), dim=-1, keepdim=True)
    zn = torch.sum(torch.square(zs), dim=-1)[None, :]
    d2 = torch.clamp_min(xn - 2.0 * torch.matmul(xs, zs.T) + zn, 0.0)
    kmn = kvar * torch.exp(-0.5 * d2)
    w = torch.matmul(kmn, kinv)
    qf = torch.sum(kmn * w, dim=-1, keepdim=True)
    mean = torch.matmul(kmn, alpha)
    var = torch.clamp_min(kvar - qf, 0.0) + torch.matmul(torch.square(w), var_q)
    return mean, var, (xs, kmn, w)


def fused_predict_plain(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    """Sparse-GP predictive (mean, var) in torch ops."""
    mean, var, _ = fused_predict_residuals_plain(x, zs, inv_ls, kvar, kinv, alpha, var_q)
    return mean, var


@functools.cache
def _library():
    """The built kernel library with its C signatures declared: nine
    (or, with residuals, eleven) pointers, four ints (n, m, di, d) and
    the stream."""
    lib = _build.load("gp_predict")
    for n_ptr, fns in ((9, (lib.gp_predict_f32, lib.gp_predict_f64)),
                       (11, (lib.gp_predict_residuals_f32, lib.gp_predict_residuals_f64))):
        for fn in fns:
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.gp_predict_error_string.argtypes = [ctypes.c_int]
    lib.gp_predict_error_string.restype = ctypes.c_char_p
    lib.gp_predict_max_m.argtypes = [ctypes.c_int] * 3
    lib.gp_predict_max_m.restype = ctypes.c_int
    return lib


@functools.cache
def _max_m(device_index: int, f64: bool, di: int, d: int) -> int:
    lib = _library()
    with torch.cuda.device(device_index):
        got = lib.gp_predict_max_m(int(f64), di, d)
    if got < 0:
        raise RuntimeError(f"gp_predict_max_m failed ({-got}: "
                           f"{lib.gp_predict_error_string(-got).decode()})")
    return got


def max_inducing_points(dtype, di: int, d: int, device="cuda") -> int:
    """The largest M (inducing points) the kernels take at (DI, D) in
    ``dtype`` on the CUDA ``device``: all of kinv is staged in shared
    memory, with the smallest row tile, within the device's opt-in limit
    per block. Computed by the kernel library from its own layout."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return _max_m(index, dtype == torch.float64, di, d)


def _check(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    if x.dim() != 2:
        raise ValueError(f"fused_predict: x must be [N, DI], got {list(x.shape)}")
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_predict: no kernel for device {x.device}")
    if x.device.type == "cuda" and x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused_predict: the kernel takes float32 or float64, got {x.dtype}")
    return n, m, di, d


def _outputs(x, n, m, d, n_out):
    """Empty output buffers: [N, D] mean and var, then [N, M] kmn and w."""
    shapes = [(n, d), (n, d), (n, m), (n, m)][:n_out]
    return [torch.empty(s, dtype=x.dtype, device=x.device) for s in shapes]


def _launch(name, inputs, n, m, di, d, n_out):
    """Launch entry ``name`` + ``_f32``/``_f64`` on the inputs' stream;
    returns the ``n_out`` outputs (see :func:`_outputs`). Raises before
    the launch if M is past the kernel's shared-memory cap."""
    x = inputs[0]
    cap = max_inducing_points(x.dtype, di, d, x.device)
    if m > cap:
        raise ValueError(
            f"{name}: M={m} inducing points do not fit the kernel's shared memory at "
            f"DI={di}, D={d} in {x.dtype} on {x.device}; the largest M that fits is {cap}"
        )
    outs = _outputs(x, n, m, d, n_out)
    entry = name + ("_f32" if x.dtype == torch.float32 else "_f64")
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in (*inputs, *outs)), n, m, di, d, stream
        )
    if err != 0:
        msg = lib.gp_predict_error_string(err).decode()
        raise RuntimeError(
            f"{name} kernel launch failed ({err}: {msg}) at N={n} M={m} DI={di} D={d}"
        )
    return outs


def _fused_predict_value(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    args = (x, zs, inv_ls, kvar, kinv, alpha, var_q)
    n, m, di, d = _check(*args)
    if x.device.type == "cpu":
        return fused_predict_plain(*args)
    if n == 0:  # no rows: empty outputs, no launch
        return tuple(_outputs(x, n, m, d, 2))
    mean, var = _launch("gp_predict", args, n, m, di, d, 2)
    fused_predict.launches += 1
    return mean, var


def fused_predict_residuals(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    """``(mean [N, D], var [N, D], kmn [N, M], w [N, M])`` at x: the
    forward of the training path (``_pallas_forward(with_residuals=True)``).

    Same operands as :func:`fused_predict`. On a CUDA tensor it launches
    ``gp_predict_residuals`` and counts the launch in
    ``fused_predict_residuals.launches``; on a CPU tensor it takes
    :func:`fused_predict_residuals_plain`.
    """
    args = (x, zs, inv_ls, kvar, kinv, alpha, var_q)
    n, m, di, d = _check(*args)
    if x.device.type == "cpu":
        mean, var, (_, kmn, w) = fused_predict_residuals_plain(*args)
        return mean, var, kmn, w
    if n == 0:  # no rows: empty outputs, no launch
        return tuple(_outputs(x, n, m, d, 4))
    outs = _launch("gp_predict_residuals", args, n, m, di, d, 4)
    fused_predict_residuals.launches += 1
    return tuple(outs)


fused_predict_residuals.launches = 0


def fused_predict_bwd(res, gm, gv):
    """Analytic VJP of the fused predictive (port of ``_bwd``, term for
    term). ``res`` is ``(x, zs, inv_ls, kvar, kinv, alpha, var_q, xs,
    kmn, w)``; ``gm``/``gv`` are the cotangents of mean and var. Returns
    the cotangents of the seven inputs (``d_kvar`` 0-d). ``kinv`` is
    taken as symmetric, as in the reference."""
    x, zs, inv_ls, kvar, kinv, alpha, var_q, xs, kmn, w = res
    # the (kvar - qf) base term is clamped at 0 in the forward; its
    # cotangent flows only where the clamp is inactive
    qf = torch.sum(kmn * w, dim=-1, keepdim=True)
    active = (kvar - qf > 0.0).to(gv.dtype)  # [N, 1]
    s = torch.sum(gv, dim=-1, keepdim=True) * active  # [N, 1]
    d_var_q = torch.matmul(torch.square(w).T, gv)  # [M, D]
    d_alpha = torch.matmul(kmn.T, gm)  # [M, D]
    # w enters var through -qf (w * kmn) and through (w*w) @ var_q
    d_w = -s * kmn + 2.0 * w * torch.matmul(gv, var_q.T)  # [N, M]
    d_kinv = torch.matmul(kmn.T, d_w)  # [M, M]
    # kmn enters mean, w = kmn @ kinv (kinv symmetric), and -qf
    d_kmn = torch.matmul(gm, alpha.T) + torch.matmul(d_w, kinv) - s * w  # [N, M]
    d_kvar = torch.sum(gv * active) + torch.sum(d_kmn * kmn) / kvar
    # the forward clamps d2 = max(d2raw, 0); where the clamp is active
    # the gradient through d2 is zero: recompute the strict mask
    xn = torch.sum(torch.square(xs), dim=-1, keepdim=True)  # [N, 1]
    zn = torch.sum(torch.square(zs), dim=-1)  # [M]
    d2raw = xn - 2.0 * torch.matmul(xs, zs.T) + zn[None, :]
    d_d2 = torch.where(d2raw > 0.0, -0.5 * kmn * d_kmn, 0.0)  # [N, M]
    d_xs = 2.0 * (torch.sum(d_d2, dim=-1, keepdim=True) * xs - torch.matmul(d_d2, zs))
    d_zs = 2.0 * (torch.sum(d_d2, dim=0)[:, None] * zs - torch.matmul(d_d2.T, xs))
    d_x = d_xs * inv_ls
    d_inv_ls = torch.sum(d_xs * x, dim=0)
    return d_x, d_zs, d_inv_ls, d_kvar, d_kinv, d_alpha, d_var_q


class FusedPredict(torch.autograd.Function):
    """The fused predictive with its analytic backward: the forward
    launches ``gp_predict_residuals`` (or its plain version on the CPU),
    the backward is :func:`fused_predict_bwd`."""

    @staticmethod
    def forward(ctx, x, zs, inv_ls, kvar, kinv, alpha, var_q):
        mean, var, kmn, w = fused_predict_residuals(x, zs, inv_ls, kvar, kinv, alpha, var_q)
        ctx.save_for_backward(x, zs, inv_ls, kvar, kinv, alpha, var_q, kmn, w)
        return mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gm, gv):
        x, zs, inv_ls, kvar, kinv, alpha, var_q, kmn, w = ctx.saved_tensors
        # xs is recomputed rather than saved, as _fwd does
        res = (x, zs, inv_ls, kvar, kinv, alpha, var_q, x * inv_ls, kmn, w)
        return fused_predict_bwd(res, gm, gv)


def fused_predict(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    """Sparse-GP predictive (mean [N, D], var [N, D]) at x.

    x: [N, DI] query points; zs: [M, DI] inducing inputs times inv_ls;
    inv_ls: [DI]; kvar: [] kernel variance; kinv: [M, M] inverse of the
    jittered Gram; alpha: [M, D] kinv @ variational mean; var_q: [M, D]
    variational variances. All on one device, in one dtype, contiguous.

    When autograd records (grad mode on and an input requires grad) the
    call goes through :class:`FusedPredict`, whose forward is
    :func:`fused_predict_residuals`. Otherwise it launches the kernel
    ``gp_predict`` on a CUDA tensor, counted in
    ``fused_predict.launches``, and takes :func:`fused_predict_plain` on
    a CPU tensor.
    """
    args = (x, zs, inv_ls, kvar, kinv, alpha, var_q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedPredict.apply(*args)
    return _fused_predict_value(*args)


fused_predict.launches = 0
