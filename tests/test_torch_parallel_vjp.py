"""The port's log-depth scan reverse (``ops/parallel_vjp.py``) against the
JAX package's ``scan_outputs_vjp`` and the plain loop (CPU, float64).

tests/test_parallel_vjp.py's toy recursion (a nonlinear per-row step
with loop constants, per-step inputs and a row-coupling extra output)
reaches every cotangent path: the affine chain, the constants, the
per-step inputs and the initial carry. The primal equals the plain loop
bitwise; gradients equal JAX's at rtol 1e-8 / atol 1e-12, alone and
under ``torch.func.vmap`` against ``jax.vmap``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbfssm_tpu.ops.parallel_vjp import scan_outputs_vjp as jax_scan_outputs_vjp
from cbfssm_tpu_torch.ops import parallel_vjp
from cbfssm_tpu_torch.ops.parallel_vjp import scan_outputs_vjp
from tests.test_parallel_vjp import build, loss_from_outs, toy_step

RTOL, ATOL = 1e-8, 1e-12


def step(consts, c, inp):
    """tests/test_parallel_vjp.py's ``toy_step`` in torch."""
    w, bias = consts
    u, eps = inp
    h = torch.tanh(c @ w + bias) + 0.3 * c
    c_next = h + eps * torch.sqrt(1.0 + torch.square(u))
    extra = torch.sum(torch.log(1.0 + torch.square(c_next)), dim=-1)
    return c_next, (c_next, extra)


def loss(outs):
    carries, extra = outs
    return torch.sum(torch.sin(carries)) + 2.0 * torch.sum(extra)


def as_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def flat_args(consts, c0, inputs):
    return (*consts, c0, *inputs)


def port_loss(w, bias, c0, u, eps):
    return loss(scan_outputs_vjp(step, (w, bias), c0, (u, eps)))


def jax_loss(w, bias, c0, u, eps):
    return loss_from_outs(jax_scan_outputs_vjp(toy_step, (w, bias), c0, (u, eps)))


def plain_outputs(w, bias, c, u, eps):
    """The loop of ``step`` written out: (carries, extras) stacked."""
    carries, extras = [], []
    for t in range(u.shape[0]):
        c, (_, extra) = step((w, bias), c, (u[t], eps[t]))
        carries.append(c)
        extras.append(extra)
    return torch.stack(carries), torch.stack(extras)


def test_primal_is_the_plain_loop():
    args = as_torch(flat_args(*build(np.random.default_rng(0))))
    got = scan_outputs_vjp(step, args[:2], args[2], args[3:])
    want = plain_outputs(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("t_len", [1, 2, 7, 16])
def test_grads_match_jax(t_len):
    args = flat_args(*build(np.random.default_rng(t_len), t_len=t_len))
    want = jax.jit(jax.grad(jax_loss, argnums=tuple(range(5))))(*args)
    leaves = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    got = torch.autograd.grad(port_loss(*leaves), leaves)
    # and the plain loop's autograd, which they must both equal
    plain = torch.autograd.grad(loss(plain_outputs(*leaves)), leaves)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=RTOL, atol=ATOL)


def test_grads_match_jax_under_vmap():
    """Lanes: ``torch.func.vmap`` of the loss over a leading axis of every
    argument, differentiated by autograd outside and by ``torch.func.grad``
    inside, against ``jax.vmap(jax.grad)``."""
    rng = np.random.default_rng(3)
    lanes = [flat_args(*build(rng, t_len=9)) for _ in range(2)]
    args = [np.stack(a) for a in zip(*lanes)]
    want = jax.jit(jax.vmap(jax.grad(jax_loss, argnums=tuple(range(5)))))(
        *map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    got = torch.autograd.grad(torch.func.vmap(port_loss)(*leaves).sum(), leaves)
    inner = torch.func.vmap(torch.func.grad(port_loss, argnums=tuple(range(5))))(
        *(torch.tensor(a) for a in args))
    for g, i, w in zip(got, inner, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(i.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t_len", [1, 2, 5, 8, 13])
def test_affine_scan_is_the_sequential_composition(t_len):
    """Each prefix of the log-depth scan equals composing the maps one
    after another with ``_affine_combine``."""
    rng = np.random.default_rng(t_len)
    mats = torch.tensor(rng.normal(size=(t_len, 3, 4, 4)))
    offs = torch.tensor(rng.normal(size=(t_len, 3, 4)))
    got_a, got_b = parallel_vjp._affine_scan(mats, offs)
    acc = (mats[0], offs[0])
    for k in range(t_len):
        if k:
            acc = parallel_vjp._affine_combine(acc, (mats[k], offs[k]))
        np.testing.assert_allclose(got_a[k].numpy(), acc[0].numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got_b[k].numpy(), acc[1].numpy(), rtol=1e-12, atol=1e-12)
