"""Persistent compile cache of ``torch.compile`` (port of
``cbfssm_tpu/utils/xla_cache.py``).

An exported predictor is compiled when it is loaded on the card
(:func:`cbfssm_tpu_torch.export._compile_program`); caching Inductor's
compiled graphs and Triton's kernels on disk makes every later process
that loads the same artifact start warm. The variable is the JAX
package's, so deployment settings carry over: opt out with
``CBFSSM_XLA_CACHE=0``, override the location with
``CBFSSM_XLA_CACHE=<dir>``.
"""

from __future__ import annotations

import os
import sys

DEFAULT = "~/.cache/cbfssm_tpu_torch/inductor"

_enabled_path: str | None = None


def enable_persistent_cache(path: str | None = None) -> bool:
    """Point Inductor's on-disk caches (its FX-graph and AOTAutograd
    caches, ``TORCHINDUCTOR_CACHE_DIR``, and Triton's kernel cache,
    ``TRITON_CACHE_DIR`` = ``<path>/triton``) at ``path`` (default:
    $CBFSSM_XLA_CACHE or ~/.cache/cbfssm_tpu_torch/inductor). Call it
    before the first compile: Inductor's compile workers take the
    locations from the environment when they start. Returns True when
    the cache is active AT THE REQUESTED LOCATION. The first successful
    call latches; a later call asking for a DIFFERENT explicit path
    returns False rather than pretending the new location took effect."""
    global _enabled_path
    env = os.environ.get("CBFSSM_XLA_CACHE")
    if env == "0":
        return False
    want = os.path.abspath(os.path.expanduser(path or env or DEFAULT))
    if _enabled_path is not None:
        if path is not None and want != _enabled_path:
            print(f"persistent compile cache already at {_enabled_path}; "
                  f"ignoring request for {want}", file=sys.stderr)
            return False
        return True
    try:
        os.makedirs(want, exist_ok=True)
        import torch._functorch.config as aot_config
        import torch._inductor.config as inductor_config

        os.environ["TORCHINDUCTOR_CACHE_DIR"] = want
        os.environ["TRITON_CACHE_DIR"] = os.path.join(want, "triton")
        inductor_config.fx_graph_cache = True
        aot_config.enable_autograd_cache = True
        _enabled_path = want
    except Exception:
        return False
    return True
