"""The port stands alone: no module of `repro_torch`, nor `chip_smoke.py`,
loads JAX, anything of the JAX package `repro`, or `ml_dtypes` (which the
card's machine does not have)."""
import pathlib
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
new = ["repro_torch.core.ptq", "repro_torch.kernels.conv2d.ops",
       "repro_torch.kernels.maxpool2d.ops", "repro_torch.kernels.sigmoid_pla.ops",
       "repro_torch.core.deploy", "repro_torch.optim.adam",
       "repro_torch.streaming.loadgen", "repro_torch.serving.router",
       "repro_torch.serving.disagg", "repro_torch.analysis.mfu",
       "repro_torch.analysis.launches", "repro_torch.configs.base",
       "repro_torch.configs.granite_3_2b", "repro_torch.configs.jamba_1_5_large_398b",
       "repro_torch.configs.smallnet", "repro_torch.models.layers",
       "repro_torch.models.attention", "repro_torch.models.moe",
       "repro_torch.models.scan_utils", "repro_torch.models.mamba",
       "repro_torch.models.rwkv6", "repro_torch.models.transformer",
       "repro_torch.models.model", "repro_torch.serving.engine",
       "repro_torch.launch.serve", "repro_torch.analysis.profiler_windows",
       "repro_torch.data.lm_data", "repro_torch.checkpoint.ckpt",
       "repro_torch.runtime.steps", "repro_torch.runtime.fault",
       "repro_torch.runtime.trainer", "repro_torch.launch.train",
       "repro_torch.distributed.sharding", "repro_torch.distributed.compression",
       "repro_torch.launch.mesh", "repro_torch.launch.lowering",
       "repro_torch.launch.dryrun", "repro_torch.analysis.roofline",
       "repro_torch.analysis.run_roofline"]
assert all(m in names for m in new), sorted(set(new) - set(names))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 60, out.stdout             # every module was imported
    assert bad == "[]", f"modules loaded: {bad}"


def test_chip_smoke_alone_fails_without_printing_a_result(tmp_path):
    import torch
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    dirs = [tmp_path] if torch.cuda.is_available() else [tmp_path, ROOT]
    for cwd in dirs:                      # alone, and in the repo without CUDA
        out = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and out.stdout.strip() == ""
