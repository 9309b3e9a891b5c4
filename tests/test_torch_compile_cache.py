"""The port's persistent compile cache
(``cbfssm_tpu_torch.utils.compile_cache``): the contract of
``cbfssm_tpu/utils/xla_cache.py`` as tests/test_utils.py pins it for
JAX — the first successful call latches, a later call asking for a
different explicit path returns False and says so — and the
``CBFSSM_XLA_CACHE`` variable: ``0`` opts out, a path overrides the
location. That a compile after the call writes under the directory is
tested with the compiled predictor (tests/test_torch_compiled_artifact.py),
to compile once."""

import os

import pytest

from cbfssm_tpu_torch.utils import compile_cache


@pytest.fixture
def fresh(monkeypatch):
    """No latch yet, no variable set, and the locations Inductor and
    Triton read restored after the test."""
    monkeypatch.setattr(compile_cache, "_enabled_path", None)
    for name in ("CBFSSM_XLA_CACHE", "TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_latch_rejects_different_path(fresh, tmp_path, capsys):
    """The first successful enable latches; a later call asking for a
    DIFFERENT explicit dir must return False, not pretend it took."""
    fresh.setenv("CBFSSM_XLA_CACHE", str(tmp_path / "cache"))
    assert compile_cache.enable_persistent_cache()
    active = compile_cache._enabled_path
    assert active == str(tmp_path / "cache")
    # re-request of the active path (or default) stays True
    assert compile_cache.enable_persistent_cache()
    assert compile_cache.enable_persistent_cache(active)
    assert not compile_cache.enable_persistent_cache(str(tmp_path / "elsewhere"))
    assert compile_cache._enabled_path == active  # unchanged
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == active
    assert "ignoring request" in capsys.readouterr().err


def test_opt_out(fresh, tmp_path):
    """CBFSSM_XLA_CACHE=0 turns the cache off, an explicit path too, and
    nothing latches or points Inductor anywhere."""
    fresh.setenv("CBFSSM_XLA_CACHE", "0")
    assert not compile_cache.enable_persistent_cache()
    assert not compile_cache.enable_persistent_cache(str(tmp_path / "cache"))
    assert compile_cache._enabled_path is None
    assert "TORCHINDUCTOR_CACHE_DIR" not in os.environ
    assert not (tmp_path / "cache").exists()


def test_override_points_inductor_and_triton(fresh, tmp_path):
    """CBFSSM_XLA_CACHE=<dir> is the location: Inductor's FX-graph and
    AOTAutograd caches there, Triton's under ``triton``, both caches on."""
    import torch._functorch.config as aot_config
    import torch._inductor.config as inductor_config
    from torch._inductor.runtime.cache_dir_utils import cache_dir

    want = tmp_path / "override"
    fresh.setenv("CBFSSM_XLA_CACHE", str(want))
    fresh.setattr(inductor_config, "fx_graph_cache", False)
    fresh.setattr(aot_config, "enable_autograd_cache", False)
    assert compile_cache.enable_persistent_cache()
    assert want.is_dir()
    assert cache_dir() == str(want)
    assert os.environ["TRITON_CACHE_DIR"] == str(want / "triton")
    assert inductor_config.fx_graph_cache and aot_config.enable_autograd_cache


def test_explicit_path_over_the_variable_and_the_default(fresh, tmp_path):
    """An explicit path wins over the variable; without either the
    location is ~/.cache/cbfssm_tpu_torch/inductor."""
    fresh.setenv("CBFSSM_XLA_CACHE", str(tmp_path / "from_env"))
    assert compile_cache.enable_persistent_cache(str(tmp_path / "explicit"))
    assert compile_cache._enabled_path == str(tmp_path / "explicit")
    fresh.setattr(compile_cache, "_enabled_path", None)
    fresh.delenv("CBFSSM_XLA_CACHE")
    fresh.setenv("HOME", str(tmp_path / "home"))
    assert compile_cache.enable_persistent_cache()
    assert compile_cache._enabled_path == str(
        tmp_path / "home" / ".cache" / "cbfssm_tpu_torch" / "inductor")
