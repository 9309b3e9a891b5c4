"""Log-depth reverse pass for latency-bound scans (port of
``cbfssm_tpu/ops/parallel_vjp.py``).

Autograd through a T-step loop runs a second sequential loop of depth T.
Where each step's device work is tiny (the Voliro recursions: [B*S,
M=20] GP links, rigid-body physics), that loop is pure latency. The
cotangent recurrence itself is linear,

    v_t = J_t^T v_{t+1} + (the step's own cotangents),

so once the step Jacobians ``J_t`` are formed (batched over all t at
once), the chain collapses to a scan of depth ceil(log2 T) over [D, D]
products, and every other cotangent (loop constants, per-step inputs)
comes from one batched vjp.

What the wrapped step must satisfy:

* the carry is one tensor ``[..., D]`` whose step Jacobian is
  block-diagonal over every leading axis (each row evolves on its own,
  as per-particle SSM recursions do);
* ``step(consts, carry, inp) -> (carry_next, (carry_next, *extras))``:
  the new carry is the first stacked output (the backward rebuilds the
  carries from it, so the primal stores nothing more), and the extras
  are tensors;
* ``consts`` and ``inputs`` are tuples (nested tuples, lists or dicts
  allowed) of tensors; ``inputs`` have the step axis first.

Cost: D jvps (one vmapped jvp) and two vjps (one linearization) of the
T-batched step replace T sequential reverse links. Gradients equal
autograd's up to the reassociation of the Jacobian products.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def _affine_combine(left, right):
    """Compose affine maps ``w -> A w + b``: ``right`` applied after
    ``left`` (elements ordered by application along the scan axis).
    A: [..., D, D], b: [..., D]."""
    a1, b1 = left
    a2, b2 = right
    return torch.matmul(a2, a1), torch.matmul(a2, b1[..., None])[..., 0] + b2


def _affine_scan(mats, offs):
    """Inclusive scan of :func:`_affine_combine` along axis 0 in
    ceil(log2 T) levels (Hillis-Steele): level ``k`` composes each
    element with the one ``2**k`` before it, as batched matmuls."""
    t_len, shift = mats.shape[0], 1
    while shift < t_len:
        a, b = _affine_combine((mats[:-shift], offs[:-shift]), (mats[shift:], offs[shift:]))
        mats = torch.cat((mats[:shift], a))
        offs = torch.cat((offs[:shift], b))
        shift *= 2
    return mats, offs


def scan_outputs_vjp(step, consts, carry0, inputs, unroll: int = 1):
    """The loop of ``step`` over the leading axis of ``inputs``,
    returning the stacked outputs ``(carries [T, ...], *extras)``, with
    a backward of depth ~log2(T) (:class:`ScanOutputs`). The final carry
    is the last row of ``carries``. ``unroll`` is accepted for the JAX
    package's signature and has no effect."""
    del unroll
    flat, spec = pytree.tree_flatten((consts, carry0, inputs))
    return ScanOutputs.apply(step, spec, *flat)


def _per_step(inputs, t):
    return pytree.tree_map(lambda a: a[t], inputs)


class ScanOutputs(torch.autograd.Function):
    """``apply(step, spec, *leaves)`` with ``leaves`` the flattened
    ``(consts, carry0, inputs)`` of ``spec``: the forward is a plain loop
    of ``step`` (so its values are the loop's bit for bit), the backward
    the log-depth pullback."""

    generate_vmap_rule = True

    @staticmethod
    def forward(step, spec, *flat):
        consts, carry, inputs = pytree.tree_unflatten(list(flat), spec)
        t_len = pytree.tree_leaves(inputs)[0].shape[0]
        outs = []
        for t in range(t_len):
            carry, out = step(consts, carry, _per_step(inputs, t))
            outs.append(out)
        return tuple(torch.stack([o[k] for o in outs]) for k in range(len(outs[0])))

    @staticmethod
    def setup_context(ctx, inputs, output):
        step, spec, *flat = inputs
        ctx.step, ctx.spec = step, spec
        ctx.save_for_backward(*flat, output[0])

    @staticmethod
    def backward(ctx, d_stack, *d_extras):
        *flat, carries = ctx.saved_tensors
        step = ctx.step
        consts, carry0, inputs = pytree.tree_unflatten(flat, ctx.spec)
        t_len, d = carries.shape[0], carry0.shape[-1]
        # the carry into step t: carry0 for t = 0, else output t - 1
        c_in = torch.cat((carry0[None], carries[:-1]))

        def batched(c_all, inp_all, co):
            return torch.func.vmap(lambda c, i: step(co, c, i))(c_all, inp_all)

        # the step Jacobians J[t, ..., i, j] = d carry_next_i / d carry_j,
        # block-diagonal over the leading axes: one basis tangent per
        # carry dimension, all D in one vmapped jvp
        def column(tangent):
            return torch.func.jvp(lambda c: batched(c, inputs, consts)[0], (c_in,),
                                  (tangent,))[1]

        basis = torch.eye(d, dtype=c_in.dtype, device=c_in.device)
        tangents = torch.zeros_like(c_in)[None] + basis.reshape((d,) + (1,) * (c_in.dim() - 1)
                                                                + (d,))
        jac = torch.movedim(torch.func.vmap(column)(tangents), 0, -1)  # [T, ..., D, D]
        jac_t = jac.transpose(-1, -2)

        # one linearization of the T-batched step, pulled back twice
        _, pull = torch.func.vjp(batched, c_in, inputs, consts)
        zero_c = torch.zeros_like(c_in)
        e_all = pull((zero_c, (torch.zeros_like(d_stack), *d_extras)))[0]

        # the affine cotangent recurrence w_{t-1} = J_t^T w_t + e_t +
        # d_stack_{t-1}, w_{T-1} = d_stack_{T-1}; reindexed k = T-1-t
        # (application order), scanned in log depth
        eye = torch.zeros_like(jac_t[0]) + basis
        mats = torch.cat((eye[None], torch.flip(jac_t, (0,))[:-1]))
        offs = torch.cat((d_stack[t_len - 1:],
                          torch.flip(e_all, (0,))[:-1] + torch.flip(d_stack, (0,))[1:]))
        _, w_rev = _affine_scan(mats, offs)
        w = torch.flip(w_rev, (0,))  # w[t]: the whole cotangent of carry_next_t

        # step t's carry output takes the chain part w_t - d_stack_t;
        # its stacked output takes d_stack_t
        d_c_all, d_inputs, d_consts = pull((w - d_stack, (d_stack, *d_extras)))
        d_flat = pytree.tree_leaves((d_consts, d_c_all[0], d_inputs))
        return (None, None, *d_flat)
