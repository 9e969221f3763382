"""The port's boundaries: it imports no JAX, a kernel wrapper given a CUDA
tensor launches or raises (never falls back to its plain version), and
``chip_smoke.py`` fails, printing no result, where there is no GPU or no
repository around it."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import circuits_halo2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "tests")
import test_torch_cuda
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "circuits_halo2_tpu.native")
print(len(names), bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    # a subprocess: this test process has JAX loaded by tests/conftest.py
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/test_torch_cuda.py"])
def test_card_side_files_import_only_the_port(path):
    """What runs on the card names no module of JAX or of the JAX package."""
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "circuits_halo2_tpu")]
    assert not bad, bad


def _fake_cuda(shape):
    """A stand-in for a CUDA tensor (this torch build cannot make one)."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=FT.DTYPE,
                           device=torch.device("cuda", 0), dim=lambda: len(shape))


def test_cpu_build_cannot_make_cuda_tensors():
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")


def test_kernel_wrappers_raise_instead_of_falling_back(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")

    def no_fallback(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(PK, "hash_batch_ref", no_fallback)
    monkeypatch.setattr(MK, "segmented_scan_ref", no_fallback)
    with pytest.raises(RuntimeError):
        PK.hash_batch(_fake_cuda((3, 16, 128)))
    pts = _fake_cuda((16, 2, 64))
    flags = SimpleNamespace(shape=torch.Size((2, 64)))
    with pytest.raises(RuntimeError):
        MK.segmented_scan(pts, pts, flags, flags, 16)


def test_wrappers_reject_other_devices():
    meta = torch.empty((2, 16, 8), dtype=FT.DTYPE, device="meta")
    with pytest.raises(ValueError):
        PK.hash_batch(meta)


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
