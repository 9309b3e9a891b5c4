"""The port's fused GP predict against the JAX package's.

``fused_predict_plain`` is held against ``_reference_forward`` in
float64 (rtol 1e-10) and against the Pallas kernel run in interpret mode
in float32 (rtol 2e-5, atol 1e-5: the tolerance of
tests/test_pallas_gp.py). The CUDA kernel itself runs only on a GPU: its
tests are marked ``cuda`` and skip here. JAX is imported inside the
tests that compare with it, so that on a GPU machine without the JAX
package's dependencies

    python -m pytest --noconftest tests/test_torch_fused_predict.py

runs the kernel tests (tests/conftest.py imports JAX).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cbfssm_tpu_torch.ops import _build
from cbfssm_tpu_torch.ops import fused_predict as fp
from cbfssm_tpu_torch.utils.kernel_timing import (FILTER_SHAPES, KERNEL_SHAPES, MODEL_SHAPES,
                                                   clamp_kernel_inputs, ill_conditioned_inputs,
                                                   kernel_inputs)

ROOT = Path(__file__).resolve().parents[1]


def make_inputs(rng, n=37, m=11, di=5, d=3, dtype=None):
    """tests/test_pallas_gp.py make_inputs (JAX arrays); skips where the
    JAX package cannot be imported."""
    source = pytest.importorskip("tests.test_pallas_gp")
    import jax.numpy as jnp

    return source.make_inputs(rng, n=n, m=m, di=di, d=d, dtype=dtype or jnp.float64)


def reference():
    """The JAX package's fused-predict module (skips where it cannot be
    imported)."""
    return pytest.importorskip("cbfssm_tpu.ops.pallas.gp_predict")


def to_torch(inputs, dtype=torch.float64):
    return tuple(torch.tensor(np.asarray(a), dtype=dtype) for a in inputs)


def plain_inputs(rng, n, m, di, d, dtype, device):
    """The same construction in numpy (no JAX): kernel_timing.kernel_inputs."""
    return kernel_inputs(rng, n, m, di, d, dtype, device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,di,d", [(37, 11, 5, 3), (1, 1, 1, 1), (64, 20, 6, 4), (5, 9, 2, 1)])
def test_plain_matches_reference_forward_f64(n, m, di, d):
    inputs = make_inputs(np.random.default_rng(n + m), n=n, m=m, di=di, d=d)
    want_mean, want_var, _ = reference()._reference_forward(*inputs)
    got_mean, got_var = fp.fused_predict_plain(*to_torch(inputs))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got_var.numpy(), np.asarray(want_var), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("n,m,di,d", [(19, 7, 4, 2), (37, 11, 5, 3)])
def test_plain_matches_pallas_interpret_f32(n, m, di, d):
    """The Pallas kernel run in interpret mode, exactly as
    tests/test_pallas_gp.py runs it, against the port's plain version."""
    import functools

    jfp = reference()
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    inputs = make_inputs(np.random.default_rng(0), n=n, m=m, di=di, d=d, dtype=jnp.float32)
    orig = pl.pallas_call
    with jax.disable_jit():
        try:
            pl.pallas_call = functools.partial(orig, interpret=True)
            want_mean, want_var = jfp._pallas_forward(*inputs, tile_n=8)
        finally:
            pl.pallas_call = orig
    got_mean, got_var = fp.fused_predict_plain(*to_torch(inputs, torch.float32))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got_var.numpy(), np.asarray(want_var), rtol=2e-5, atol=1e-5)


def test_d2_clamp_inputs_forward_matches():
    """The near-coincident large-norm inputs of
    tests/test_pallas_gp.py::test_analytic_vjp_masks_d2_clamp, where the
    d2 clamp engages: the forward values match."""
    rng = np.random.default_rng(0)
    x, zs, inv_ls, kvar, kinv, alpha, var_q = make_inputs(rng, n=6)
    zs = zs + 1e3
    x = (zs[0:6] + rng.normal(size=x.shape) * 1e-5) / inv_ls
    inputs = (x, zs, inv_ls, kvar, kinv, alpha, var_q)
    xs = np.asarray(x * inv_ls)
    d2raw = (xs**2).sum(-1)[:, None] - 2.0 * xs @ np.asarray(zs).T + (np.asarray(zs) ** 2).sum(-1)
    assert (d2raw < 0).any(), "test setup: clamp never engaged"
    want_mean, want_var, _ = reference()._reference_forward(*inputs)
    got_mean, got_var = fp.fused_predict_plain(*to_torch(inputs))
    # |zs|^2 ~ 6e6 here, so d2 carries an absolute rounding of about
    # eps * 6e6 ~ 1e-9 that depends on the summation order: atol 1e-8
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(got_var.numpy(), np.asarray(want_var), rtol=1e-10, atol=1e-8)
    assert (got_var >= 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_takes_plain_path_without_launch(monkeypatch, dtype):
    args = plain_inputs(np.random.default_rng(1), 37, 11, 5, 3, dtype, "cpu")
    monkeypatch.setattr(fp.fused_predict, "launches", 0)
    got = fp.fused_predict(*args)
    want = fp.fused_predict_plain(*args)
    assert fp.fused_predict.launches == 0
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(g, w)


def test_wrapper_checks_shapes_dtypes_devices():
    args = list(plain_inputs(np.random.default_rng(2), 37, 11, 5, 3, torch.float64, "cpu"))
    bad_shape = args.copy()
    bad_shape[4] = args[4][:-1]  # kinv [M-1, M]
    with pytest.raises(ValueError, match="kinv"):
        fp.fused_predict(*bad_shape)
    bad_dtype = args.copy()
    bad_dtype[5] = args[5].float()
    with pytest.raises(ValueError, match="alpha"):
        fp.fused_predict(*bad_dtype)
    strided = args.copy()
    strided[0] = torch.cat((args[0], args[0]), dim=1)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fp.fused_predict(*strided)
    with pytest.raises(ValueError, match="no kernel for device"):
        fp.fused_predict(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match=r"\[N, DI\]"):
        fp.fused_predict(args[0][0], *args[1:])


def test_module_imports_and_builds_nothing_without_nvcc():
    """Importing the kernel module needs no nvcc and builds nothing; the
    build is named by the source hash."""
    def libraries():
        return sorted(_build.BUILD_DIR.glob("*.so"))

    before = libraries()
    code = "import cbfssm_tpu_torch, cbfssm_tpu_torch.ops.fused_predict\n"
    env = {"PATH": "/nonexistent", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert libraries() == before
    lib = _build.library_path("gp_predict")
    assert lib.parent == ROOT / "build" / "cbfssm_tpu_torch"
    assert lib.name.startswith("gp_predict_") and lib.suffix == ".so"
    assert lib == _build.library_path("gp_predict")


def test_nvcc_missing_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-5),
                                             (torch.float64, 1e-10, 1e-12)])
@pytest.mark.parametrize("n,m,di,d", KERNEL_SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, dtype, rtol, atol, n, m, di, d):
    args = plain_inputs(np.random.default_rng(n), n, m, di, d, dtype, cuda_device)
    before = fp.fused_predict.launches
    got = fp.fused_predict(*args)
    torch.cuda.synchronize()
    assert fp.fused_predict.launches == before + 1
    want = fp.fused_predict_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
    with pytest.raises(ValueError, match="float32 or float64"):
        fp.fused_predict(*(a.half() for a in args))


def test_custom_op_on_cpu_is_the_plain_version():
    """``cbfssm_torch::gp_predict`` (the form the kernel takes in exported
    programs) on CPU tensors: the plain version, bitwise, no launch."""
    args = plain_inputs(np.random.default_rng(2), 37, 11, 5, 3, torch.float64, "cpu")
    before = fp.fused_predict.launches
    got = torch.ops.cbfssm_torch.gp_predict(*args)
    assert fp.fused_predict.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, fp.fused_predict_plain(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_custom_op_launches_the_kernel(cuda_device, dtype):
    """On CUDA tensors the op is the wrapper: one counted launch, the
    wrapper's result bitwise, and the wrapper's refusals (no fallback)."""
    args = plain_inputs(np.random.default_rng(3), 1600, 100, 6, 4, dtype, cuda_device)
    before = fp.fused_predict.launches
    got = torch.ops.cbfssm_torch.gp_predict(*args)
    torch.cuda.synchronize()
    assert fp.fused_predict.launches == before + 1
    want = fp._fused_predict_value(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="float32 or float64"):
        torch.ops.cbfssm_torch.gp_predict(*(a.half() for a in args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_on_d2_clamp_inputs(cuda_device, dtype):
    """``gp_predict`` where the d2 clamp engages (64 rows, each next to an
    inducing point). alpha is the identity (D = M = 11), so that mean is
    kmn exactly: each entry is one product with 1 plus products with 0.
    In both dtypes mean never exceeds kvar (an unclamped negative d2
    would give kmn > kvar; in float32 d2 rounds to multiples of 0.5 here,
    see clamp_kernel_inputs), var is not negative and all is finite. In
    float64 it matches the plain version at the tolerance of
    test_d2_clamp_inputs_forward_matches (atol 1e-8: d2 carries ~1e-9
    absolute rounding that depends on the summation order)."""
    x, zs, inv_ls, kvar, kinv, _, _ = clamp_kernel_inputs(dtype, cuda_device, n=64)
    m = zs.shape[0]
    alpha = torch.eye(m, dtype=dtype, device=cuda_device)
    var_q = torch.full((m, m), 0.1, dtype=dtype, device=cuda_device)
    args = (x, zs, inv_ls, kvar, kinv, alpha, var_q)
    mean, var = fp.fused_predict(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()
    assert (var >= 0).all()
    assert (mean <= kvar).all()
    if dtype == torch.float64:
        want = fp.fused_predict_plain(*args)
        for g, ref in zip((mean, var), want):
            torch.testing.assert_close(g, ref, rtol=1e-10, atol=1e-8)


def empty_rows_calls(device, dtype):
    """Both wrappers and FusedPredict's backward at N = 0 (M = 11,
    DI = 5, D = 3): outputs, launch counts before and after, gradients."""
    args = list(plain_inputs(np.random.default_rng(3), 0, 11, 5, 3, dtype, device))
    before = (fp.fused_predict.launches, fp.fused_predict_residuals.launches)
    value = fp._fused_predict_value(*args)
    residuals = fp.fused_predict_residuals(*args)
    leaves = [a.clone().requires_grad_(True) for a in args]
    mean, var = fp.fused_predict(*leaves)
    grads = torch.autograd.grad((mean.sum() + var.sum()), leaves)
    after = (fp.fused_predict.launches, fp.fused_predict_residuals.launches)
    return args, value, residuals, grads, before, after


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_empty_rows_give_empty_outputs_and_zero_grads(device):
    """N = 0: empty [0, D] / [0, M] outputs, no launch counted, and the
    backward returns zeros of each input's shape."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    args, value, residuals, grads, before, after = empty_rows_calls(device, torch.float64)
    assert [tuple(t.shape) for t in value] == [(0, 3), (0, 3)]
    assert [tuple(t.shape) for t in residuals] == [(0, 3), (0, 3), (0, 11), (0, 11)]
    assert after == before
    for g, a in zip(grads, args):
        assert g.shape == a.shape and g.device == a.device
        assert torch.equal(g, torch.zeros_like(a))


def nan_filled_allocator(device, dtype, shapes, copies=8):
    """Leave the caching allocator's free blocks of these shapes full of
    NaN, so that an output buffer the kernel fails to write shows up."""
    junk = [torch.full(s, float("nan"), dtype=dtype, device=device)
            for s in shapes for _ in range(copies)]
    torch.cuda.synchronize()
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,di", [(1600, 100, 6), (37, 11, 5)])
def test_cuda_no_output_column(cuda_device, dtype, n, m, di):
    """D = 0 (a CBFSSM with dim_x = dim_y has a recognition GP of no
    output column): the residual kernel still writes kmn and w, and the
    gradients through FusedPredict are finite and equal autograd of the
    plain version."""
    rtol, atol = (2e-5, 1e-5) if dtype == torch.float32 else (1e-10, 1e-12)
    args = plain_inputs(np.random.default_rng(n), n, m, di, 0, dtype, cuda_device)
    nan_filled_allocator(cuda_device, dtype, [(n, m)])
    before = (fp.fused_predict.launches, fp.fused_predict_residuals.launches)
    mean, var = fp._fused_predict_value(*args)
    got = fp.fused_predict_residuals(*args)
    torch.cuda.synchronize()
    assert (fp.fused_predict.launches, fp.fused_predict_residuals.launches) == (
        before[0] + 1, before[1] + 1)
    assert tuple(mean.shape) == tuple(var.shape) == (n, 0)
    _, _, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
    assert [tuple(t.shape) for t in got] == [(n, 0), (n, 0), (n, m), (n, m)]
    torch.testing.assert_close(got[2], kmn, rtol=rtol, atol=atol)
    torch.testing.assert_close(got[3], w, rtol=rtol, atol=atol)
    nan_filled_allocator(cuda_device, dtype, [(n, m)])
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(fp.fused_predict_plain(*leaves)[1].sum(), leaves[1:],
                               allow_unused=True, materialize_grads=True)
    got_g = torch.autograd.grad(fp.FusedPredict.apply(*leaves)[1].sum(), leaves[1:])
    for g, ref in zip(got_g, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_inducing_point_cap(cuda_device, dtype):
    """All of kinv sits in shared memory, so M is capped: at the cap
    both kernels run and match the plain version; one past it both
    wrappers raise before the launch, naming M, DI, D, the dtype and
    the cap."""
    rtol, atol = (2e-5, 1e-5) if dtype == torch.float32 else (1e-10, 1e-12)
    di, d = 6, 4
    cap = fp.max_inducing_points(dtype, di, d, cuda_device)
    assert 100 < cap < 1000 and fp.max_inducing_points(dtype, di, 2, cuda_device) >= cap
    args = plain_inputs(np.random.default_rng(cap), 37, cap, di, d, dtype, cuda_device)
    got = fp.fused_predict_residuals(*args)
    torch.cuda.synchronize()
    mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
    for g, ref in zip(got, (mean, var, kmn, w)):
        torch.testing.assert_close(g, ref, rtol=rtol, atol=atol)
    for g, ref in zip(fp._fused_predict_value(*args), (mean, var)):
        torch.testing.assert_close(g, ref, rtol=rtol, atol=atol)
    over = plain_inputs(np.random.default_rng(0), 37, cap + 1, di, d, dtype, cuda_device)
    before = (fp.fused_predict.launches, fp.fused_predict_residuals.launches)
    match = (rf"M={cap + 1} .*DI={di}, D={d} in {dtype}.*largest M that fits is {cap}")
    with pytest.raises(ValueError, match=match):
        fp._fused_predict_value(*over)
    with pytest.raises(ValueError, match=match):
        fp.fused_predict_residuals(*over)
    assert (fp.fused_predict.launches, fp.fused_predict_residuals.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("residuals", [False, True])
def test_cuda_float32_kernel_on_ill_conditioned_kinv(cuda_device, residuals):
    """kinv the inverse of the jittered RBF Gram of 100 inducing points
    (jitter 1e-6, condition number ~8.2e4, entries up to ~1.1e3): w =
    kmn @ kinv cancels terms far larger than itself. The float32
    kernel's largest error in mean, var and w against the float64 plain
    version on the same (float32) operands is within 2x of the float32
    plain version's (its products are 3xTF32 on the tensor cores)."""
    args, cond = ill_conditioned_inputs(torch.float32, cuda_device)
    assert 5e4 < cond < 5e5
    kernel = fp.fused_predict_residuals if residuals else fp._fused_predict_value
    got = kernel(*args)
    torch.cuda.synchronize()
    mean, var, (_, _, w) = fp.fused_predict_residuals_plain(*(a.double() for a in args))
    plain_mean, plain_var, (_, _, plain_w) = fp.fused_predict_residuals_plain(*args)
    names = ("mean", "var", "w") if residuals else ("mean", "var")
    outs = (got[0], got[1], got[3]) if residuals else got
    for name, g, p, truth in zip(names, outs, (plain_mean, plain_var, plain_w), (mean, var, w)):
        err = float((g.double() - truth).abs().max())
        plain_err = float((p.double() - truth).abs().max())
        assert err <= 2 * plain_err, f"{name}: kernel {err:.3e}, plain {plain_err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-5),
                                             (torch.float64, 1e-10, 1e-12)])
@pytest.mark.parametrize("path", sorted(MODEL_SHAPES))
def test_cuda_kernels_at_model_shapes(cuda_device, dtype, rtol, atol, path):
    """Both kernels against their plain versions at the shapes of the
    Voliro and Sarcos paths (mean, var and, with residuals, kmn and w);
    at D = 6, 7 and 14 every pass of the per-row reduction adds the same
    base variance."""
    n, m, di, d = MODEL_SHAPES[path]
    args = plain_inputs(np.random.default_rng(n + d), n, m, di, d, dtype, cuda_device)
    before = (fp.fused_predict.launches, fp.fused_predict_residuals.launches)
    value = fp._fused_predict_value(*args)
    residuals = fp.fused_predict_residuals(*args)
    torch.cuda.synchronize()
    assert (fp.fused_predict.launches, fp.fused_predict_residuals.launches) == (
        before[0] + 1, before[1] + 1)
    mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
    for g, ref in zip((*value, *residuals), (mean, var, mean, var, kmn, w)):
        torch.testing.assert_close(g, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("di,d", [(12, 3), (19, 6), (21, 7), (21, 14)])
def test_cuda_inducing_point_cap_at_model_widths(cuda_device, dtype, di, d):
    """The cap at the Voliro and Sarcos widths lies above their M (20,
    100), and at the cap both kernels match the plain version."""
    rtol, atol = (2e-5, 1e-5) if dtype == torch.float32 else (1e-10, 1e-12)
    cap = fp.max_inducing_points(dtype, di, d, cuda_device)
    assert 100 < cap < 1000
    args = plain_inputs(np.random.default_rng(cap + di), 37, cap, di, d, dtype, cuda_device)
    got = (*fp._fused_predict_value(*args), *fp.fused_predict_residuals(*args))
    torch.cuda.synchronize()
    mean, var, (_, kmn, w) = fp.fused_predict_residuals_plain(*args)
    for g, ref in zip(got, (mean, var, mean, var, kmn, w)):
        torch.testing.assert_close(g, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 1e-5),
                                             (torch.float64, 1e-10, 1e-12)])
@pytest.mark.parametrize("path", sorted(FILTER_SHAPES))
def test_cuda_value_kernel_at_filter_shapes(cuda_device, dtype, rtol, atol, path):
    """The value kernel against its plain version at the online-filter
    shapes: a 1,024-session RoboMove fleet (N = 51,200 rows, 800 row
    tiles), 32 sessions, one stream, and a Voliro pool."""
    n, m, di, d = FILTER_SHAPES[path]
    args = plain_inputs(np.random.default_rng(n + di), n, m, di, d, dtype, cuda_device)
    before = fp.fused_predict.launches
    got = fp.fused_predict(*args)
    torch.cuda.synchronize()
    assert fp.fused_predict.launches == before + 1
    want = fp.fused_predict_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
