"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and nothing quietly runs on the CPU when a
CUDA device is asked for and absent."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20  # every module imported


def test_entry_points_raise_for_an_absent_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.experiments import paper_cnn

    with pytest.raises(RuntimeError, match="cuda"):
        paper_cnn.load_params()  # device defaults to "cuda"
    params = paper_cnn.load_params("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        paper_cnn.eval_accuracy(params, None, 8, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        paper_cnn.make_batched_evaluator(params, 8)


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
