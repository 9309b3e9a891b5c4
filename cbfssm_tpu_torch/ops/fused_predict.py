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
- Lanes: both wrappers take ``lanes=True`` (the aliases
  :func:`fused_predict_lanes` and :func:`fused_predict_residuals_lanes`)
  and then run L independent predicts in one launch (every operand with
  a leading lane axis), the counterpart of the batched ``pallas_call``
  that ``jax.vmap`` makes of the two kernels; :class:`FusedPredict` on a
  lane-major x pairs the second with the lane form of the backward.
  Under ``torch.func.vmap`` (multi-seed and sweep training)
  :func:`fused_predict` goes through the ``vmap`` rules of the two
  Functions: a batched tensor has no ``data_ptr()``, so the rule moves
  each lane axis to the front and calls the lane kernels on the plain
  tensors beneath. Lane launches are counted apart, in
  ``lane_launches``. A call while the stream is captured into a CUDA
  graph launches nothing: it is counted in ``captures`` (``lane_captures``)
  instead, and the graph runs the kernel at each replay.

- Exported programs: :func:`gp_predict_op` registers the value path as
  the custom op ``cbfssm_torch::gp_predict`` (CUDA: the wrapper, counted;
  CPU: :func:`fused_predict_plain`; a fake for tracing).
  :func:`fused_predict` calls it only while ``torch.export`` traces, so
  each ``gp_predict`` of an exported program is one node of its graph and,
  on the card, one launch; eager calls skip the op's dispatch.

The kernels are built with ``nvcc`` at the first CUDA call
(:mod:`cbfssm_tpu_torch.ops._build`), never at import; the op is
registered at import (no build).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch._C._functorch import is_batchedtensor
from torch.autograd.function import once_differentiable

from cbfssm_tpu_torch.ops import _build


def fused_predict_residuals_plain(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    """Sparse-GP predictive in torch ops: ``(mean, var, (xs, kmn, w))``,
    the counterpart of ``_reference_forward`` and the kernels' reference.
    Every operand may carry a leading lane axis (kvar then [L]): the
    plain version of the lane kernels."""
    kvar = kvar[..., None, None]
    xs = x * inv_ls.unsqueeze(-2)
    xn = torch.sum(torch.square(xs), dim=-1, keepdim=True)
    zn = torch.sum(torch.square(zs), dim=-1).unsqueeze(-2)
    # zs^T contiguous: CPU BLAS takes another path for a transposed operand
    # at 2-4 rows, so a row's result would depend on the row count
    d2 = torch.clamp_min(xn - 2.0 * torch.matmul(xs, zs.mT.contiguous()) + zn, 0.0)
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
    (or, with residuals, eleven) pointers, four ints (n, m, di, d), or
    five with lanes (lanes, n, m, di, d), and the stream."""
    lib = _build.load("gp_predict")
    for name, n_ptr in (("gp_predict", 9), ("gp_predict_residuals", 11)):
        for lanes in ("", "_lanes"):
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + lanes + suffix)
                n_int = 5 if lanes else 4
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
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


def _check(x, zs, inv_ls, kvar, kinv, alpha, var_q, lanes: bool = False):
    """(L, N, M, DI, D) of the operands (L = 1 without lanes); raises on
    a shape, device, dtype or layout the kernels do not take."""
    if x.dim() != 2 + lanes:
        want_x = "[L, N, DI]" if lanes else "[N, DI]"
        raise ValueError(f"fused_predict: x must be {want_x}, got {list(x.shape)}")
    lead = tuple(x.shape[:1]) if lanes else ()
    n, di = x.shape[-2:]
    m, d = zs.shape[-2], alpha.shape[-1]
    want = {
        "zs": (zs, (m, di)), "inv_ls": (inv_ls, (di,)), "kvar": (kvar, ()),
        "kinv": (kinv, (m, m)), "alpha": (alpha, (m, d)), "var_q": (var_q, (m, d)),
    }
    want = {k: (t, lead + shape) for k, (t, shape) in want.items()}
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
    return (x.shape[0] if lanes else 1), n, m, di, d


def _outputs(x, lead, n, m, d, n_out):
    """Empty output buffers: [N, D] mean and var, then [N, M] kmn and w,
    each behind the leading axes ``lead`` (``(L,)`` with lanes)."""
    shapes = [(n, d), (n, d), (n, m), (n, m)][:n_out]
    return [torch.empty(lead + s, dtype=x.dtype, device=x.device) for s in shapes]


def _run(name, wrapper, args, lanes: bool):
    """The body of both wrappers: check the operands; on a CPU tensor
    return the plain version; with no rows (or no lanes) return empty
    outputs without a launch; else launch entry ``name`` (+ ``_lanes``
    with ``lanes``) + ``_f32``/``_f64`` on the inputs' stream and count
    it in ``wrapper.launches`` (``wrapper.lane_launches`` with lanes), or
    in ``wrapper.captures`` (``wrapper.lane_captures``) while the stream
    is captured into a CUDA graph.
    Raises before the launch if M is past the kernel's shared-memory cap
    (which holds per lane)."""
    n_lanes, n, m, di, d = _check(*args, lanes=lanes)
    n_out = 2 if name == "gp_predict" else 4
    x = args[0]
    if x.device.type == "cpu":
        mean, var, (_, kmn, w) = fused_predict_residuals_plain(*args)
        return (mean, var, kmn, w)[:n_out]
    lead = (n_lanes,) if lanes else ()
    if n_lanes == 0 or n == 0:
        return tuple(_outputs(x, lead, n, m, d, n_out))
    cap = max_inducing_points(x.dtype, di, d, x.device)
    if m > cap:
        raise ValueError(
            f"{name}: M={m} inducing points do not fit the kernel's shared memory at "
            f"DI={di}, D={d} in {x.dtype} on {x.device}; the largest M that fits is {cap}"
        )
    outs = _outputs(x, lead, n, m, d, n_out)
    entry = name + ("_lanes" if lanes else "") + (
        "_f32" if x.dtype == torch.float32 else "_f64")
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in (*args, *outs)), *lead, n, m, di, d, stream
        )
    if err != 0:
        msg = lib.gp_predict_error_string(err).decode()
        raise RuntimeError(
            f"{entry} kernel launch failed ({err}: {msg}) at L={n_lanes} N={n} M={m} "
            f"DI={di} D={d}"
        )
    counter = ("lane_" if lanes else "") + (
        "captures" if torch.cuda.is_current_stream_capturing() else "launches")
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    return tuple(outs)


def _fused_predict_value(x, zs, inv_ls, kvar, kinv, alpha, var_q, lanes: bool = False):
    """``(mean, var)``: the value path of :func:`fused_predict`, kernel
    ``gp_predict``, counted in ``fused_predict.launches``. With ``lanes``
    every operand carries a leading lane axis (x [L, N, DI], zs [L, M,
    DI], inv_ls [L, DI], kvar [L], kinv [L, M, M], alpha and var_q
    [L, M, D]), lane l of each against lane l of the others, in one launch
    of ``gp_predict_lanes`` counted in ``fused_predict.lane_launches``."""
    return _run("gp_predict", fused_predict, (x, zs, inv_ls, kvar, kinv, alpha, var_q), lanes)


def fused_predict_residuals(x, zs, inv_ls, kvar, kinv, alpha, var_q, lanes: bool = False):
    """``(mean [N, D], var [N, D], kmn [N, M], w [N, M])`` at x: the
    forward of the training path (``_pallas_forward(with_residuals=True)``).

    Same operands as :func:`fused_predict`. On a CUDA tensor it launches
    ``gp_predict_residuals`` and counts the launch in
    ``fused_predict_residuals.launches``; on a CPU tensor it takes
    :func:`fused_predict_residuals_plain`. With ``lanes``, operands and
    outputs as for :func:`_fused_predict_value` with lanes, and the launch
    of ``gp_predict_residuals_lanes`` is counted in
    ``fused_predict_residuals.lane_launches``.
    """
    return _run("gp_predict_residuals", fused_predict_residuals,
                (x, zs, inv_ls, kvar, kinv, alpha, var_q), lanes)


fused_predict_residuals.launches = 0
fused_predict_residuals.lane_launches = 0
fused_predict_residuals.captures = 0
fused_predict_residuals.lane_captures = 0
# the lane forms of the two wrappers: L independent predicts in one launch
fused_predict_lanes = functools.partial(_fused_predict_value, lanes=True)
fused_predict_residuals_lanes = functools.partial(fused_predict_residuals, lanes=True)


def fused_predict_bwd(res, gm, gv):
    """Analytic VJP of the fused predictive (port of ``_bwd``, term for
    term). ``res`` is ``(x, zs, inv_ls, kvar, kinv, alpha, var_q, xs,
    kmn, w)``; ``gm``/``gv`` are the cotangents of mean and var. Returns
    the cotangents of the seven inputs (``d_kvar`` 0-d). ``kinv`` is
    taken as symmetric, as in the reference. Every operand may carry a
    leading lane axis (the lane kernels' residuals, ``d_kvar`` then
    [L]): lanes are independent, so each gets its own cotangents."""
    x, zs, inv_ls, kvar, kinv, alpha, var_q, xs, kmn, w = res
    kv = kvar[..., None, None]
    # the (kvar - qf) base term is clamped at 0 in the forward; its
    # cotangent flows only where the clamp is inactive
    qf = torch.sum(kmn * w, dim=-1, keepdim=True)
    active = (kv - qf > 0.0).to(gv.dtype)  # [N, 1]
    s = torch.sum(gv, dim=-1, keepdim=True) * active  # [N, 1]
    d_var_q = torch.matmul(torch.square(w).mT, gv)  # [M, D]
    d_alpha = torch.matmul(kmn.mT, gm)  # [M, D]
    # w enters var through -qf (w * kmn) and through (w*w) @ var_q
    d_w = -s * kmn + 2.0 * w * torch.matmul(gv, var_q.mT)  # [N, M]
    d_kinv = torch.matmul(kmn.mT, d_w)  # [M, M]
    # kmn enters mean, w = kmn @ kinv (kinv symmetric), and -qf
    d_kmn = torch.matmul(gm, alpha.mT) + torch.matmul(d_w, kinv) - s * w  # [N, M]
    d_kvar = (torch.sum(gv * active, dim=(-2, -1))
              + torch.sum(d_kmn * kmn, dim=(-2, -1)) / kvar)
    # the forward clamps d2 = max(d2raw, 0); where the clamp is active
    # the gradient through d2 is zero: recompute the strict mask
    xn = torch.sum(torch.square(xs), dim=-1, keepdim=True)  # [N, 1]
    zn = torch.sum(torch.square(zs), dim=-1)  # [M]
    d2raw = xn - 2.0 * torch.matmul(xs, zs.mT) + zn.unsqueeze(-2)
    d_d2 = torch.where(d2raw > 0.0, -0.5 * kmn * d_kmn, 0.0)  # [N, M]
    d_xs = 2.0 * (torch.sum(d_d2, dim=-1, keepdim=True) * xs - torch.matmul(d_d2, zs))
    d_zs = 2.0 * (torch.sum(d_d2, dim=-2).unsqueeze(-1) * zs - torch.matmul(d_d2.mT, xs))
    d_x = d_xs * inv_ls.unsqueeze(-2)
    d_inv_ls = torch.sum(d_xs * x, dim=-2)
    return d_x, d_zs, d_inv_ls, d_kvar, d_kinv, d_alpha, d_var_q


def _lane_operands(info, in_dims, args):
    """The operands of a vmapped call as plain lane-major tensors: each
    batched operand's lane axis to the front, the unbatched ones expanded
    to the batch, all contiguous (what the lane kernels take)."""
    lanes = []
    for a, dim in zip(args, in_dims):
        a = a.expand((info.batch_size,) + a.shape) if dim is None else a.movedim(dim, 0)
        lanes.append(a.contiguous())
    return lanes


class FusedPredict(torch.autograd.Function):
    """The fused predictive with its analytic backward: ``apply`` returns
    ``(mean, var)``. The forward launches ``gp_predict_residuals`` (or
    its plain version on the CPU), or its lane entry when x carries a
    lane axis ([L, N, DI]); its kmn and w are two more outputs, without
    gradient, which ``setup_context`` saves and ``apply`` drops; the
    backward is :func:`fused_predict_bwd`. Under ``torch.func.vmap`` the
    rule calls it again on the lane-major operands."""

    @classmethod
    def apply(cls, *args):
        return cls.apply_residuals(*args)[:2]

    @classmethod
    def apply_residuals(cls, *args):
        """``(mean, var, kmn, w)``; kmn and w carry no gradient."""
        return super().apply(*args)

    @staticmethod
    def forward(x, zs, inv_ls, kvar, kinv, alpha, var_q):
        return fused_predict_residuals(x, zs, inv_ls, kvar, kinv, alpha, var_q,
                                       lanes=x.dim() == 3)

    @staticmethod
    def setup_context(ctx, inputs, output):
        # the backward needs the inputs and the residuals kmn, w
        ctx.mark_non_differentiable(output[2], output[3])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs, output[2], output[3])

    @staticmethod
    @once_differentiable
    def backward(ctx, gm, gv, _gk, _gw):
        x, zs, inv_ls, kvar, kinv, alpha, var_q, kmn, w = ctx.saved_tensors
        lead = kmn.shape[:-1]
        d = alpha.shape[-1]
        gm = gm if gm is not None else kmn.new_zeros(lead + (d,))
        gv = gv if gv is not None else kmn.new_zeros(lead + (d,))
        # xs is recomputed rather than saved, as _fwd does
        res = (x, zs, inv_ls, kvar, kinv, alpha, var_q, x * inv_ls.unsqueeze(-2), kmn, w)
        return fused_predict_bwd(res, gm, gv)

    @staticmethod
    def vmap(info, in_dims, *args):
        return FusedPredict.apply_residuals(*_lane_operands(info, in_dims, args)), (0, 0, 0, 0)


class FusedPredictValue(torch.autograd.Function):
    """The value path of :func:`fused_predict` (``gp_predict``, no
    gradient) as a Function, only so that ``torch.func.vmap`` reaches its
    vmap rule: a batched tensor has no ``data_ptr()`` for the kernel.

    Inside ``vmap`` a batched tensor reports ``requires_grad`` False
    whatever it wraps, so :func:`fused_predict` sends every call with a
    batched operand here; the rule looks at the plain lane-major tensors
    instead. With grad mode on and one of them requiring grad it goes
    through :class:`FusedPredict` (the residual lane kernel and the lane
    backward), otherwise through the value lane kernel."""

    @staticmethod
    def forward(x, zs, inv_ls, kvar, kinv, alpha, var_q):
        return _fused_predict_value(x, zs, inv_ls, kvar, kinv, alpha, var_q)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        lanes = _lane_operands(info, in_dims, args)
        if torch.is_grad_enabled() and any(a.requires_grad for a in lanes):
            return FusedPredict.apply(*lanes), (0, 0)
        return fused_predict_lanes(*lanes), (0, 0)


def _batched(args) -> bool:
    """Whether an operand is batched by ``torch.func.vmap``."""
    return any(is_batchedtensor(t) for t in args)


@torch.library.custom_op(
    "cbfssm_torch::gp_predict", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor zs, Tensor inv_ls, Tensor kvar, Tensor kinv, Tensor alpha, "
           "Tensor var_q) -> (Tensor, Tensor)")
def gp_predict_op(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    """The value kernel as the custom op ``cbfssm_torch::gp_predict``,
    the form in which it enters a ``torch.export`` program. On a CUDA
    tensor it is :func:`_fused_predict_value` (one launch of
    ``gp_predict``, counted in ``fused_predict.launches``; it raises
    where the wrapper raises); on a CPU tensor :func:`fused_predict_plain`."""
    return _fused_predict_value(x, zs, inv_ls, kvar, kinv, alpha, var_q)


@gp_predict_op.register_kernel("cpu")
def _gp_predict_op_cpu(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    return fused_predict_plain(x, zs, inv_ls, kvar, kinv, alpha, var_q)


@gp_predict_op.register_fake
def _gp_predict_op_fake(x, zs, inv_ls, kvar, kinv, alpha, var_q):
    shape = (x.shape[0], alpha.shape[-1])
    return x.new_empty(shape), x.new_empty(shape)


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
    a CPU tensor. Under ``torch.func.vmap`` the lane kernels run, one
    launch for all lanes: a call with a batched operand goes through
    :class:`FusedPredictValue` (a plain call skips that Function's
    dispatch). While ``torch.export`` traces, the value path is the
    custom op :func:`gp_predict_op`, one node of the exported graph
    (eager calls skip the op's dispatch).
    """
    args = (x, zs, inv_ls, kvar, kinv, alpha, var_q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedPredict.apply(*args)
    if _batched(args):
        return FusedPredictValue.apply(*args)
    if torch.compiler.is_exporting():
        return gp_predict_op(*args)
    return _fused_predict_value(*args)


fused_predict.launches = 0
fused_predict.lane_launches = 0
fused_predict.captures = 0
fused_predict.lane_captures = 0
