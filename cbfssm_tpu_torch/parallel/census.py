"""Collective census of a call (port of ``cbfssm_tpu/parallel/census.py``).

The data mesh's contract: parameters replicated, batch rows sharded,
and the only cross-device traffic the gradient reduction (plus scalar
loss reductions), never a batch-sized all-gather. Loss-equality tests
cannot check it: a step that gathers every shard and computes the whole
batch on every rank gives the same losses.

The JAX package reads the collectives out of a compiled program's HLO.
Eager PyTorch compiles nothing, so this module records the collectives
a call *performs*: :func:`record` runs a block under a
``TorchDispatchMode`` that sees every ``c10d`` op (``dist.all_reduce``
dispatches ``c10d.allreduce_``), names each with the JAX kind
(``all-reduce``, ``all-gather``, ...) and takes its payload from the
tensors it returns. :func:`census`, :func:`describe` and
:func:`assert_data_parallel_contract` read those records.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "all-to-all",
    "collective-permute",
    "reduce-scatter",
    "collective-broadcast",
    "ragged-all-to-all",
    # no XLA counterpart: rooted collectives and the barrier
    "reduce",
    "gather",
    "scatter",
    "barrier",
)

# c10d / functional-collective op name -> kind
_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "broadcast_": "collective-broadcast",
    "broadcast": "collective-broadcast",
    "reduce_": "reduce",
    "gather_": "gather",
    "scatter_": "scatter",
    "barrier": "barrier",
}

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int32: "s32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


@dataclass(frozen=True)
class Collective:
    kind: str  # one of COLLECTIVE_KINDS
    shapes: tuple[str, ...]  # result shape(s), e.g. "f64[123]"
    result_bytes: int  # total result payload on this rank
    op_name: str  # the dispatched op, e.g. "c10d.allreduce_.default"
    result_elements: int = 0


class _Recorder(TorchDispatchMode):
    def __init__(self, items: list):
        super().__init__()
        self.items = items

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _KINDS.get(func._schema.name.split("::")[-1])
            if kind is not None:
                tensors = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
                self.items.append(Collective(
                    kind=kind,
                    shapes=tuple(f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}"
                                 f"[{','.join(str(d) for d in t.shape)}]" for t in tensors),
                    result_bytes=sum(t.numel() * t.element_size() for t in tensors),
                    op_name=str(func),
                    result_elements=sum(t.numel() for t in tensors),
                ))
        return out


@contextlib.contextmanager
def record():
    """``with record() as items:`` fills ``items`` with a
    :class:`Collective` for each collective the block performs, in order."""
    items: list[Collective] = []
    with _Recorder(items):
        yield items


def collectives(fn, *args, **kwargs) -> list[Collective]:
    """The collectives that ``fn(*args, **kwargs)`` performs, in order."""
    with record() as items:
        fn(*args, **kwargs)
    return items


def census(items) -> dict[str, int]:
    """{collective kind: count} of recorded collectives."""
    counts: dict[str, int] = {}
    for c in items:
        counts[c.kind] = counts.get(c.kind, 0) + 1
    return counts


def describe(items) -> str:
    """One line per collective: kind, payload, op (for logs)."""
    if not items:
        return "collective census: none (embarrassingly parallel)"
    lines = [f"collective census: {len(items)} instruction(s)"]
    for c in items:
        lines.append(f"  {c.kind:<20} {c.result_bytes:>8} B  {'+'.join(c.shapes)}  "
                     f"[{c.op_name}]")
    return "\n".join(lines)


def assert_data_parallel_contract(items, max_reduce_bytes: int,
                                  context: str = "") -> list[Collective]:
    """Assert the data mesh's contract on recorded collectives: all are
    all-reduces (the gradient and scalar loss reductions) of at most
    ``max_reduce_bytes`` (size it to the parameters: a batch-sized
    operand in a reduction blows through it). Returns the records so
    callers can pin counts too."""
    items = list(items)
    where = f" in {context}" if context else ""
    bad_kinds = [c for c in items if c.kind != "all-reduce"]
    assert not bad_kinds, (
        f"non-psum collective(s){where}: "
        + "; ".join(f"{c.kind} {c.shapes} ({c.op_name})" for c in bad_kinds)
    )
    too_big = [c for c in items if c.result_bytes > max_reduce_bytes]
    assert not too_big, (
        f"all-reduce payload(s) exceed {max_reduce_bytes} B{where} "
        "(batch-sized operand in a psum?): "
        + "; ".join(f"{c.shapes} = {c.result_bytes} B" for c in too_big)
    )
    return items
