"""Guards on the port as a whole: it loads no JAX, its smoke script refuses
to run without a CUDA card, the CPU path never counts a kernel launch, and
the kernel build looks for nvcc and keys its output by the sources."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from vit_cifar_torch import Config
from vit_cifar_torch.models import get_model
from vit_cifar_torch.ops.cuda import build
from vit_cifar_torch.ops.cuda.attention import fused_attention
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_smoke_script_load_no_jax():
    code = ("import importlib, pkgutil, sys, vit_cifar_torch, chip_smoke\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "vit_cifar_torch.__path__, 'vit_cifar_torch.')]\n"
            "assert 'vit_cifar_torch.train.steps' in mods, mods\n"
            "assert 'vit_cifar_torch.ops.cuda.flash_attention' in mods, mods\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vit_cifar_tpu'))\n"
            "assert not bad, bad\n"
            "print('clean')")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_smoke_script_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run(["chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "torch.cuda.is_available() is false" in res.stderr


def test_smoke_script_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_cpu_path_counts_no_launch():
    cfg = Config(model_name="vit", num_layers=2, hidden=32, mlp_hidden=32,
                 head=4)
    model, _ = get_model(cfg, device="cpu")
    before = fused_attention.launches
    with torch.no_grad():
        out = model(torch.from_numpy(
            np.random.default_rng(0).normal(size=(2, 32, 32, 3))).float())
    assert out.shape == (2, 10)
    assert fused_attention.launches == before == 0


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_library_is_keyed_by_source_and_flags(monkeypatch):
    path = build.library_path("mhsa_fwd")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("mhsa_fwd-") and path.suffix == ".so"
    assert build.BUILD_DIR.relative_to(ROOT).parts == ("build", "kernels")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("mhsa_fwd") != path
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_flash_libraries_are_keyed_by_their_sources(name):
    path = build.library_path(name)
    assert (build.CSRC_DIR / f"{name}.cu").exists()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    assert path != build.library_path("mhsa_fwd")
