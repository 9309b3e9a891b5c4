"""The port's residual-emitting fused predict and its analytic backward
against the JAX package's (``_reference_forward``, the Pallas kernel in
interpret mode, ``_bwd`` and ``jax.vjp`` of ``fused_predict``).

Tolerances: float64 forwards at rtol 1e-10 (same sums, other order);
float32 against the interpreted Pallas kernel at rtol 2e-5 / atol 1e-5
(tests/test_pallas_gp.py); cotangents at rtol 1e-7 / atol 1e-10
(tests/test_pallas_gp.py's VJP tolerance). The CUDA kernel runs only on
a GPU: its test is marked ``cuda`` and skips here. JAX is imported
inside the tests that compare with it, so that on a GPU machine without
the JAX package's dependencies ``python -m pytest --noconftest`` of this
file runs the kernel test (tests/conftest.py imports JAX).
"""

import functools

import numpy as np
import pytest
import torch

from cbfssm_tpu_torch.ops import fused_predict as fp
from cbfssm_tpu_torch.utils.kernel_timing import KERNEL_SHAPES, clamp_kernel_inputs, kernel_inputs

GRAD_RTOL, GRAD_ATOL = 1e-7, 1e-10


def reference():
    """(jax, jax.numpy, the JAX fused-predict module); skips where the
    JAX package cannot be imported."""
    jfp = pytest.importorskip("cbfssm_tpu.ops.pallas.gp_predict")
    import jax
    import jax.numpy as jnp

    return jax, jnp, jfp


def make_inputs(rng, **kw):
    """tests/test_pallas_gp.py make_inputs (JAX arrays, float64 unless
    ``dtype`` says otherwise)."""
    return pytest.importorskip("tests.test_pallas_gp").make_inputs(rng, **kw)


def to_torch(arrays, dtype=torch.float64):
    return tuple(torch.tensor(np.asarray(a), dtype=dtype) for a in arrays)


def cotangents(rng, n, d):
    return rng.normal(size=(n, d)), rng.normal(size=(n, d))


def clamp_inputs():
    """tests/test_pallas_gp.py::test_analytic_vjp_masks_d2_clamp's inputs:
    queries nearly on large-norm inducing points, so some d2raw fall
    below 0 by cancellation while xs != zs."""
    rng = np.random.default_rng(0)
    x, zs, inv_ls, kvar, kinv, alpha, var_q = make_inputs(rng, n=6)
    zs = zs + 1e3
    x = (zs[0:6] + rng.normal(size=x.shape) * 1e-5) / inv_ls
    return (x, zs, inv_ls, kvar, kinv, alpha, var_q), cotangents(rng, 6, 3)


def d2raw(xs, zs):
    xn = torch.sum(torch.square(xs), dim=-1, keepdim=True)
    return xn - 2.0 * torch.matmul(xs, zs.T) + torch.sum(torch.square(zs), dim=-1)[None, :]


def assert_grads_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, f"arg {i}"
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=rtol, atol=atol, err_msg=f"arg {i}")


@pytest.mark.parametrize("n,m,di,d", [(37, 11, 5, 3), (1, 1, 1, 1), (64, 20, 6, 4)])
def test_residuals_plain_matches_reference_forward_f64(n, m, di, d):
    _, _, jfp = reference()
    inputs = make_inputs(np.random.default_rng(n + m), n=n, m=m, di=di, d=d)
    want_mean, want_var, want_res = jfp._reference_forward(*inputs)
    got_mean, got_var, got_res = fp.fused_predict_residuals_plain(*to_torch(inputs))
    for g, w in zip((got_mean, got_var, *got_res), (want_mean, want_var, *want_res)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("n,m,di,d", [(19, 7, 4, 2), (37, 11, 5, 3)])
def test_residuals_plain_matches_pallas_interpret_f32(n, m, di, d):
    """``_pallas_forward(with_residuals=True)`` (the kernel
    ``_kernel_with_residuals``) interpreted, as tests/test_pallas_gp.py
    runs it, against the port's plain version: mean, var, kmn and w."""
    jax, jnp, jfp = reference()
    from jax.experimental import pallas as pl

    inputs = make_inputs(np.random.default_rng(1), n=n, m=m, di=di, d=d, dtype=jnp.float32)
    orig = pl.pallas_call
    with jax.disable_jit():
        try:
            pl.pallas_call = functools.partial(orig, interpret=True)
            want = jfp._pallas_forward(*inputs, tile_n=8, with_residuals=True)
        finally:
            pl.pallas_call = orig
    mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*to_torch(inputs, torch.float32))
    for name, g, ref in zip(("mean", "var", "kmn", "w"), (mean, var, kmn, w), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-5, err_msg=name)


def test_residuals_wrapper_on_cpu_takes_plain_path(monkeypatch):
    inputs = to_torch(make_inputs(np.random.default_rng(3)))
    monkeypatch.setattr(fp.fused_predict_residuals, "launches", 0)
    mean, var, kmn, w = fp.fused_predict_residuals(*inputs)
    want_mean, want_var, (_, want_kmn, want_w) = fp.fused_predict_residuals_plain(*inputs)
    assert fp.fused_predict_residuals.launches == 0
    for g, ref in zip((mean, var, kmn, w), (want_mean, want_var, want_kmn, want_w)):
        assert torch.equal(g, ref)
    with pytest.raises(ValueError, match="alpha"):
        fp.fused_predict_residuals(*inputs[:5], inputs[5].float(), inputs[6])


@pytest.mark.parametrize("n,m,di,d", [(37, 11, 5, 3), (8, 4, 2, 1)])
def test_bwd_matches_jax_bwd_on_same_residuals(n, m, di, d):
    """``fused_predict_bwd`` against ``_bwd`` term for term: the same
    residuals (JAX's ``_fwd``) and cotangents, all seven outputs."""
    _, _, jfp = reference()
    rng = np.random.default_rng(n)
    inputs = make_inputs(rng, n=n, m=m, di=di, d=d)
    gm, gv = cotangents(rng, n, d)
    _, res = jfp._fwd(*inputs)
    want = jfp._bwd(res, (gm, gv))
    got = fp.fused_predict_bwd(to_torch(res), *to_torch((gm, gv)))
    assert got[3].dim() == 0  # d_kvar is 0-d, like kvar
    assert_grads_close(got, want)


def test_function_on_cpu_matches_jax_vjp(monkeypatch):
    """``FusedPredict`` on CPU tensors: its backward is the analytic
    ``fused_predict_bwd`` (as the custom VJP applies ``_bwd`` on every
    backend), equal to ``jax.vjp`` of the JAX ``fused_predict``."""
    jax, _, jfp = reference()
    rng = np.random.default_rng(5)
    inputs = make_inputs(rng)
    gm, gv = cotangents(rng, 37, 3)
    _, vjp = jax.vjp(jfp.fused_predict, *inputs)
    want = vjp((gm, gv))

    calls = []
    real_bwd = fp.fused_predict_bwd

    def counting_bwd(*args):
        calls.append(1)
        return real_bwd(*args)

    monkeypatch.setattr(fp, "fused_predict_bwd", counting_bwd)
    args = [t.requires_grad_(True) for t in to_torch(inputs)]
    mean, var = fp.fused_predict(*args)
    assert type(mean.grad_fn).__name__ == "FusedPredictBackward"
    got = torch.autograd.grad((mean, var), args, to_torch((gm, gv)))
    assert calls == [1]
    assert_grads_close(got, want)


def test_function_matches_autograd_of_plain_and_gradcheck():
    rng = np.random.default_rng(7)
    inputs = to_torch(make_inputs(rng, n=6, m=4, di=3, d=2))
    args = [t.clone().requires_grad_(True) for t in inputs]
    torch.autograd.gradcheck(fp.FusedPredict.apply, args)
    g = to_torch(cotangents(rng, 6, 2))
    got = torch.autograd.grad(fp.FusedPredict.apply(*args), args, g)
    want = torch.autograd.grad(fp.fused_predict_plain(*args), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_d2_clamp_matches_autograd_of_plain():
    """On the clamp inputs the strict ``d2raw > 0`` mask engages; the
    port's plain forward and its backward sum in the same order as
    torch autograd of ``fused_predict_plain``, so they agree tightly."""
    inputs, cts = clamp_inputs()
    args = [t.requires_grad_(True) for t in to_torch(inputs)]
    assert bool((d2raw(args[0] * args[2], args[1]) < 0).any()), "test setup: clamp never engaged"
    got = torch.autograd.grad(fp.fused_predict(*args), args, to_torch(cts))
    want = torch.autograd.grad(fp.fused_predict_plain(*args), args, to_torch(cts))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_d2_clamp_matches_jax_bwd():
    """Against JAX's ``_bwd`` on the clamp inputs. The strict masks of
    the two packages agree entry for entry here (checked); on JAX's own
    residuals the cotangents then agree at the VJP tolerance. Each
    package's own forward puts ~1e-9 absolute rounding into d2 (|zs|^2
    is ~6e6), so kmn, and with it the cotangents, differ by up to ~1e-6
    absolute on d_inv_ls (~1.9e3 in size): that comparison holds at
    rtol 1e-7 with atol 1e-5."""
    jax, jnp, jfp = reference()
    inputs, (gm, gv) = clamp_inputs()
    _, res = jfp._fwd(*inputs)
    want = jfp._bwd(res, (gm, gv))
    jax_xs, zs = to_torch((res[7], inputs[1]))
    _, _, (xs, _, _) = fp.fused_predict_residuals_plain(*to_torch(inputs))
    mask_jax = np.asarray(
        jnp.sum(res[7] ** 2, -1)[:, None]
        - 2.0 * jnp.matmul(res[7], inputs[1].T, precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(inputs[1] ** 2, -1)[None, :]
    ) > 0
    mask_port = (d2raw(xs, zs) > 0).numpy()
    assert not mask_port.all(), "test setup: clamp never engaged"
    np.testing.assert_array_equal(mask_port, mask_jax)
    assert_grads_close(fp.fused_predict_bwd(to_torch(res), *to_torch((gm, gv))), want)

    args = [t.requires_grad_(True) for t in to_torch(inputs)]
    own = torch.autograd.grad(fp.fused_predict(*args), args, to_torch((gm, gv)))
    assert_grads_close(own, want, rtol=GRAD_RTOL, atol=1e-5)


def test_no_function_node_without_grad():
    """Serving and evaluation (no grad) take the value path: no
    ``FusedPredict`` node, outputs equal the plain version."""
    args = [t.requires_grad_(True) for t in to_torch(make_inputs(np.random.default_rng(9)))]
    with torch.no_grad():
        mean, var = fp.fused_predict(*args)
    assert mean.grad_fn is None and var.grad_fn is None
    with torch.inference_mode():
        mean_i, _ = fp.fused_predict(*args)
    assert mean_i.grad_fn is None and torch.equal(mean, mean_i)
    plain = fp.fused_predict(*(a.detach() for a in args))
    assert plain[0].grad_fn is None and torch.equal(plain[0], mean)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-5),
                                             (torch.float64, 1e-10, 1e-12)])
@pytest.mark.parametrize("n,m,di,d", KERNEL_SHAPES)
def test_cuda_residual_kernel_and_grads(dtype, rtol, atol, n, m, di, d):
    """On the card: ``gp_predict_residuals`` against its plain version
    (mean, var, kmn, w), and in float64 the gradients of
    ``FusedPredict`` against autograd of the plain version (rtol 1e-8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    args = kernel_inputs(np.random.default_rng(n), n, m, di, d, dtype, "cuda")
    before = fp.fused_predict_residuals.launches
    got = fp.fused_predict_residuals(*args)
    torch.cuda.synchronize()
    assert fp.fused_predict_residuals.launches == before + 1
    mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
    for g, ref in zip(got, (mean, var, kmn, w)):
        torch.testing.assert_close(g, ref, rtol=rtol, atol=atol)
    if dtype == torch.float64:
        leaves = [a.clone().requires_grad_(True) for a in args]
        cts = (torch.randn_like(mean), torch.randn_like(var))
        got_g = torch.autograd.grad(fp.fused_predict(*leaves), leaves, cts)
        want_g = torch.autograd.grad(fp.fused_predict_plain(*leaves), leaves, cts)
        for a, b in zip(got_g, want_g):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_residual_kernel_on_d2_clamp_inputs(dtype):
    """``gp_predict_residuals`` where the d2 clamp engages (64 rows, each
    next to an inducing point): kmn never exceeds kvar (an unclamped
    negative d2 would give kmn > kvar; in float32 d2 rounds to multiples
    of 0.5 here, see clamp_kernel_inputs), var is not negative, all
    finite; in float64 mean, var, kmn and w match the plain version at
    rtol 1e-10 / atol 1e-8 (the clamp-input tolerance of
    tests/test_torch_fused_predict.py: d2 carries ~1e-9 absolute rounding
    that depends on the summation order; in float32 ~0.5, so there only
    the clamp properties are checked)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    args = clamp_kernel_inputs(dtype, "cuda", n=64)
    got = fp.fused_predict_residuals(*args)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert (got[1] >= 0).all()
    assert (got[2] <= args[3]).all()
    if dtype == torch.float64:
        mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
        for g, ref in zip(got, (mean, var, kmn, w)):
            torch.testing.assert_close(g, ref, rtol=1e-10, atol=1e-8)
