"""The port stands alone: importing ``cbfssm_tpu_torch`` (every module)
or ``chip_smoke`` loads no JAX and no matplotlib, and ``chip_smoke.py``
refuses to run without a GPU or outside the repository, printing no
result."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

JAX_FREE = """
import sys
import cbfssm_tpu_torch, cbfssm_tpu_torch.config, cbfssm_tpu_torch.convert
import cbfssm_tpu_torch.serving, cbfssm_tpu_torch.models, cbfssm_tpu_torch.data
import cbfssm_tpu_torch.models.recognition, cbfssm_tpu_torch.models.cbfssmhalf
import cbfssm_tpu_torch.models.prssm
import cbfssm_tpu_torch.ops._build, cbfssm_tpu_torch.ops.fused_predict
import cbfssm_tpu_torch.training, cbfssm_tpu_torch.training.checkpoint
import cbfssm_tpu_torch.training.trainer, cbfssm_tpu_torch.utils.profiling
import cbfssm_tpu_torch.outputs, cbfssm_tpu_torch.outputs.calibration
import cbfssm_tpu_torch.outputs.outputs_robomove, cbfssm_tpu_torch.run_robomove
import cbfssm_tpu_torch.ops.quaternion, cbfssm_tpu_torch.ops.distributions
import cbfssm_tpu_torch.utils.rotations, cbfssm_tpu_torch.utils.kernel_timing
import cbfssm_tpu_torch.data.voliro_loader, cbfssm_tpu_torch.data.datasets
import cbfssm_tpu_torch.data.system_id_tasks, cbfssm_tpu_torch.data.ds_manager
import cbfssm_tpu_torch.data.generators, cbfssm_tpu_torch.data.synthetic
import cbfssm_tpu_torch.models.voliro
import cbfssm_tpu_torch.outputs.outputs_voliro, cbfssm_tpu_torch.outputs.summary
import cbfssm_tpu_torch.run_voliro, cbfssm_tpu_torch.run_sarcos
import cbfssm_tpu_torch.run_spring, cbfssm_tpu_torch.run_smallscale
import cbfssm_tpu_torch.create_datasets.create_robomove
import cbfssm_tpu_torch.create_datasets.create_spring_nonlinear
import cbfssm_tpu_torch.training.multiseed, cbfssm_tpu_torch.training.sweep
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cbfssm_tpu',
                                    'matplotlib'))
print(bad)
"""


def run(args, cwd, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_port_imports_no_jax():
    out = run(["-c", JAX_FREE], ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real here")
    out = run(["chip_smoke.py"], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "FAIL" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
