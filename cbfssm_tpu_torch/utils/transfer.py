"""Host-device copies that do not make the host wait for the card.

A blocking copy between host memory and the card waits for every kernel
queued before it (PyTorch synchronizes the stream around it), so one
such copy inside a run of issued work stalls the host until the card
has drained. These copies are non-blocking instead; off the card they
are plain copies. :func:`constant` uploads a fixed table once.
"""

from __future__ import annotations

import numpy as np
import torch


def upload(a, device, dtype=None):
    """A host array (or CPU tensor) on ``device``, in ``dtype`` if given,
    without a host sync: a non-blocking copy, whose pageable source the
    driver stages before the call returns (so ``a`` may change after
    it), with no wait for the card. Works under ``torch.export``'s fake
    tensors, which pinned memory does not."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a, dtype=dtype)
    return t.to(device, non_blocking=True)


_CONSTANTS = {}


def constant(key, make, device, dtype=None):
    """:func:`upload` of the host array ``make()``, made once per ``(key,
    device, dtype)`` and shared after: a fixed table that a step reads (a
    mask, a sign vector) costs no host-to-device copy at each call, and a
    CUDA graph's capture, which refuses a copy from pageable memory, can
    take the step. ``key`` names the table and every number it depends
    on; no caller writes into the tensor. It is a normal tensor even when
    first asked for under ``torch.inference_mode``, so autograd may save
    it later; under ``torch.export``'s fake tensors it is made anew at
    each call, as before."""
    if torch._guards.detect_fake_mode() is not None:
        return upload(make(), device, dtype)
    k = (key, torch.device(device), dtype)
    t = _CONSTANTS.get(k)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[k] = upload(make(), device, dtype)
    return t


def host_copy(t):
    """A host copy of ``t`` enqueued behind the work issued so far: on a
    card into pinned memory without a host sync, valid once an event
    recorded after it has completed (:func:`ready_event`)."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def ready_event(device):
    """An event recorded on ``device``'s current stream (None off the
    card, where every copy has completed already)."""
    if torch.device(device).type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event
