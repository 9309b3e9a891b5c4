"""The compiled predictor artifact (``cbfssm_tpu_torch.export``'s
``_compile_program``) on the CPU, against the uncompiled program and the
JAX package's artifact (float64).

The contract: on the card ``ExportedPredictor`` compiles its program at
load with ``torch.compile`` and the persistent compile cache, as the
JAX package jits its deserialized call; the compiled module answers
what the uncompiled program answers at rtol 1e-12 (tests/test_export.py's
tolerance of an artifact against the live predictor), and what the JAX
artifact answers at the golden rtol 1e-7 when fed the JAX draws; one
compiled call runs the custom op ``cbfssm_torch::gp_predict`` once per
node of the program; a CPU load does not compile; a failed compile
raises and nothing runs the uncompiled program in its place. The
program is compiled once for the module, on the CPU by the helper a load
on the card calls, into a fresh cache directory.
"""

import os

import jax
import numpy as np
import pytest
import torch

from cbfssm_tpu import export as jax_export
from cbfssm_tpu_torch import export
from cbfssm_tpu_torch.export import ExportedPredictor, gp_predict_nodes, load_exported_predictor
from cbfssm_tpu_torch.ops import fused_predict as fp
from cbfssm_tpu_torch.utils import compile_cache
from tests.test_torch_cbfssm import jax_noise
from tests.test_torch_export import RTOL, SEED, T, art, cbfssm, windows  # noqa: F401 (fixtures)

RTOL_PROGRAM, ATOL_PROGRAM = 1e-12, 1e-13


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """A fresh compile-cache directory that this module's compile latches
    (the latch and the locations are restored after the module)."""
    import torch._inductor.config as inductor_config

    path = tmp_path_factory.mktemp("inductor")
    with pytest.MonkeyPatch.context() as mp:
        # one compile thread: the suite's other workers keep their cores
        mp.setattr(inductor_config, "compile_threads", 1)
        mp.setattr(compile_cache, "_enabled_path", None)
        mp.setenv("CBFSSM_XLA_CACHE", str(path))
        for name in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
            mp.delenv(name, raising=False)
        yield path


@pytest.fixture(scope="module")
def compiled(art, cache_dir):  # noqa: F811 (the fixture)
    """The artifact loaded on the CPU and compiled as a load on the card
    compiles it."""
    pred = ExportedPredictor(art[0], device="cpu")
    pred.compiled = export._compile_program(pred.program, pred._zero_args())
    return pred


@pytest.fixture(scope="module")
def program(art):  # noqa: F811
    return ExportedPredictor(art[0], device="cpu")


def test_compile_writes_under_the_cache_directory(compiled, cache_dir):
    """The load compiled through the persistent cache: Inductor's graph
    and AOTAutograd entries are under the latched directory."""
    assert compiled.compiled is not None
    assert compile_cache._enabled_path == str(cache_dir)
    for sub in ("fxgraph", "aotautograd"):
        entries = [f for _, _, files in os.walk(cache_dir / sub) for f in files]
        assert entries, sub


@pytest.mark.parametrize("seed", [SEED, 123])
def test_compiled_equals_program(compiled, program, rng, seed):
    """The compiled module against the uncompiled program of the same
    artifact, the same draws: rtol 1e-12, every field."""
    u, y = windows(rng)
    got, want = compiled(u, y, seed=seed), program(u, y, seed=seed)
    assert set(got) == set(want) == set(compiled.meta["output_fields"])
    for f in want:
        assert got[f].shape == want[f].shape and got[f].dtype == torch.float64
        torch.testing.assert_close(got[f], want[f], rtol=RTOL_PROGRAM, atol=ATOL_PROGRAM)


@pytest.mark.parametrize("key", [0, 123])
def test_compiled_matches_jax_exported_predictor(cbfssm, art, compiled, rng, key):  # noqa: F811
    """Fed the JAX key schedule's draws, the compiled artifact answers
    what the JAX package's (jitted) artifact answers at that key."""
    _, _, pm, _ = cbfssm
    u, y = windows(rng)
    jkey = jax.random.PRNGKey(key)
    want = jax_export.ExportedPredictor(art[2])(u, y, jkey)
    got = compiled(u, y, noise=jax_noise(pm, jkey, T, 1))
    for f in want:
        torch.testing.assert_close(got[f], torch.as_tensor(want[f].__array__()),
                                   rtol=RTOL, atol=1e-10)


def test_compiled_call_runs_the_op_once_per_node(compiled, rng, monkeypatch):
    """The op stays a call in the compiled graph: one compiled call runs
    its body (on the CPU the plain version) once per
    ``cbfssm_torch::gp_predict`` node, as a call on the card launches
    the kernel once per node."""
    calls = []
    plain = fp.fused_predict_plain

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(fp, "fused_predict_plain", counted)
    compiled(*windows(rng))
    assert len(calls) == gp_predict_nodes(compiled.program) == 15


def test_cpu_load_does_not_compile(art, program, monkeypatch):  # noqa: F811
    """On the CPU the loaders run the program uncompiled, as a kernel
    wrapper takes its plain version there."""

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU load compiled")

    monkeypatch.setattr(torch, "compile", refuse)
    pred = load_exported_predictor(art[0], device="cpu")
    assert pred.compiled is None and program.compiled is None
    assert pred(*windows(np.random.default_rng(0)))["pred_mean"].shape == (1, T, 1)


def test_compile_failure_raises(art, monkeypatch):  # noqa: F811
    """A compile that fails fails the load: the helper catches nothing
    and never runs the uncompiled program in its place."""
    real = torch.compile

    def failing_backend(gm, example_inputs):
        raise RuntimeError("no compiler here")

    def compile_with_failing_backend(module, options=None, **kwargs):
        return real(module, backend=failing_backend, **kwargs)

    monkeypatch.setattr(torch, "compile", compile_with_failing_backend)
    pred = ExportedPredictor(art[0], device="cpu")
    with pytest.raises(Exception, match="no compiler here"):
        export._compile_program(pred.program, pred._zero_args())
