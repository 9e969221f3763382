"""The port's boundaries: it imports nothing of JAX or of the JAX package
and reads no file inside that package, a kernel wrapper given a CUDA tensor
launches or raises (never falls back to its plain version), its entry
points default to the card, and ``chip_smoke.py`` fails, printing no
result, where there is no GPU or no repository around it."""

import ast
import inspect
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree
from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "circuits_halo2_tpu_torch"
PORT_PY = sorted(str(f.relative_to(ROOT)) for f in PORT.rglob("*.py") if "_build" not in f.parts)
PORT_CSRC = sorted(str(f.relative_to(ROOT)) for f in (PORT / "csrc").iterdir() if f.is_file())

_IMPORT_ALL = """
import importlib, pkgutil, sys
import circuits_halo2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "tests")
import test_torch_cuda
import torch_parallel_tasks
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "circuits_halo2_tpu"))
mesh = {"circuits_halo2_tpu_torch.parallel." + m
        for m in ("auto", "sharding", "msm_sharded", "ntt_sharded", "worker")}
bench = {"circuits_halo2_tpu_torch.bench", "circuits_halo2_tpu_torch.bench_suite"}
need = mesh | bench
print(len(names), bad, sorted(need - set(names)))
sys.exit(1 if bad or len(names) < 20 or not need <= set(names) else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    # a subprocess: this test process has JAX loaded by tests/conftest.py
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/test_torch_cuda.py",
                                  "tests/torch_parallel_tasks.py", *PORT_PY])
def test_card_side_files_import_only_the_port(path):
    """What runs on the card, every module of the port included, names no
    module of JAX or of the JAX package."""
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "circuits_halo2_tpu")]
    assert not bad, bad


def _strings_outside_docstrings(tree):
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def _names_jax_package(text: str) -> bool:
    return any(part.startswith("circuits_halo2_tpu") and not part.startswith("circuits_halo2_tpu_torch")
               for part in text.replace("\\", "/").replace(".", "/").split("/"))


@pytest.mark.parametrize("path", PORT_PY + PORT_CSRC)
def test_port_files_name_no_path_in_the_jax_package(path):
    """No string a port module computes with (docstrings aside), and no
    ``#include`` of a kernel source, names the JAX package or a file in it."""
    text = (ROOT / path).read_text()
    if path.endswith(".py"):
        found = [s for s in _strings_outside_docstrings(ast.parse(text)) if _names_jax_package(s)]
    else:
        found = [line for line in text.splitlines()
                 if line.lstrip().startswith("#include") and _names_jax_package(line)]
    assert not found, found


def test_name_check_catches_the_old_paths():
    old = 'SRC = Path(__file__).parent.parent / "circuits_halo2_tpu" / "native" / "fieldcc.cpp"'
    assert any(_names_jax_package(s) for s in _strings_outside_docstrings(ast.parse(old)))
    assert not _names_jax_package("circuits_halo2_tpu_torch/csrc/poseidon.cu")


def test_tree_entry_points_default_to_the_card():
    from circuits_halo2_tpu_torch.merkle.device_tree import build_device_tree_sorted
    from circuits_halo2_tpu_torch.utils import ec_fft as EC
    from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

    for fn in (MerkleSumTree.from_csv, MerkleSumTree.from_entries, MerkleSumTree.from_csv_sorted,
               build_device_tree_sorted, EC.ec_fft_device, EC.g_to_lagrange, ParamsKZG.downsize,
               ParamsKZG.commit, ParamsKZG.commit_lagrange):
        assert inspect.signature(fn).parameters["device"].default == "cuda:0"


@pytest.mark.parametrize("name", ["gen_commitment", "gen_inclusion_proof",
                                  "gen_inclusion_verifier", "summa_solvency_flow",
                                  "nova_incremental_verifier"])
def test_examples_default_to_the_card(name, monkeypatch):
    """Run with no flags, each example hands its first device entry point
    (tree or setup) the card."""
    import importlib

    from circuits_halo2_tpu_torch.utils import pipeline

    class Reached(Exception):
        pass

    def reached(*args, **kwargs):
        raise Reached(kwargs.get("device", args[-1]))

    monkeypatch.setattr(MerkleSumTree, "from_csv", staticmethod(reached))
    monkeypatch.setattr(pipeline, "generate_setup_artifacts", reached)
    monkeypatch.setattr(pipeline, "generate_incremental_artifacts", reached)
    example = importlib.import_module(f"circuits_halo2_tpu_torch.examples.{name}")
    with pytest.raises(Reached) as got:
        example.main([])
    assert got.value.args == ("cuda:0",)


def test_mesh_defaults_to_the_card(monkeypatch):
    """A rank's mesh lies on its card, ``cuda:{rank % device_count}``,
    unless the caller asks for the CPU; with no card it raises."""
    import torch.distributed as dist

    from circuits_halo2_tpu_torch.parallel import sharding

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    with pytest.raises(RuntimeError):
        sharding.default_device(0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert sharding.default_device(5) == torch.device("cuda", 1)
    assert inspect.signature(sharding.make_mesh).parameters["device"].default is None
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        assert sharding.make_mesh().device == torch.device("cuda", 0)
        assert sharding.make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_proving_and_round_entry_points_default_to_the_card():
    from circuits_halo2_tpu_torch.backend.round import Round, Snapshot
    from circuits_halo2_tpu_torch.models.prover import prove
    from circuits_halo2_tpu_torch.models.prover_batch import prove_batch
    from circuits_halo2_tpu_torch.utils import pipeline

    for fn in (pipeline.generate_setup_artifacts, pipeline.generate_incremental_artifacts,
               pipeline.generate_chained_artifacts, prove, prove_batch, Snapshot, Round):
        assert inspect.signature(fn).parameters["device"].default == "cuda:0"
    # the JAX package's positional calls (its round and examples) still bind
    inspect.signature(pipeline.generate_setup_artifacts).bind(11, None, 4, 2, 8)
    inspect.signature(pipeline.generate_incremental_artifacts).bind(11, None, 4, 2, 8)
    inspect.signature(pipeline.generate_chained_artifacts).bind(13, None, 4, 2, 8, 3)


def test_incremental_rounds_build_on_the_artifacts_device(monkeypatch):
    """``prove_chain`` and ``prove_chain_snark`` build every round's tree
    on the device the artifacts were made for."""
    from circuits_halo2_tpu_torch.models import incremental as INC

    class Reached(Exception):
        pass

    def reached(entries, cryptos, device):
        raise Reached(device)

    monkeypatch.setattr(MerkleSumTree, "from_entries", staticmethod(reached))
    csv = str(ROOT / "tests" / "fixtures_csv" / "states" / "entry_16_1.csv")
    art = SimpleNamespace(circuit_shape=(4, 2, 8), device=torch.device("cuda", 0))
    for prove in (INC.prove_chain, INC.prove_chain_snark):
        with pytest.raises(Reached) as got:
            prove(art, [csv], 0)
        assert got.value.args == (torch.device("cuda", 0),)


def _fake_cuda(shape, dtype=FT.DTYPE):
    """A stand-in for a CUDA tensor (this torch build cannot make one)."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
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
    monkeypatch.setattr(PK, "permute_ref", no_fallback)
    monkeypatch.setattr(PM, "hash_batch_mxu_ref", no_fallback)
    monkeypatch.setattr(PM, "mul_ref", no_fallback)
    monkeypatch.setattr(MK, "segmented_scan_ref", no_fallback)
    monkeypatch.setattr(EXP, "run_ref", no_fallback)
    monkeypatch.setattr(EK, "ec_fft_ref", no_fallback)
    with pytest.raises(RuntimeError):
        PK.hash_batch(_fake_cuda((3, 16, 128)))
    with pytest.raises(RuntimeError):
        PK.permute(_fake_cuda((16, 100)), _fake_cuda((16, 100)))
    with pytest.raises(RuntimeError):
        PM.hash_batch_mxu(_fake_cuda((2, 16, 100)))
    with pytest.raises(RuntimeError):
        EXP.run("mxu_mul", _fake_cuda((16, 100)), _fake_cuda((16, 100)), 4)
    with pytest.raises(RuntimeError):
        EXP.mxu_mul_once(_fake_cuda((16, 100)), _fake_cuda((16, 100)))
    pts = _fake_cuda((16, 2, 64))
    flags = SimpleNamespace(shape=torch.Size((2, 64)))
    with pytest.raises(RuntimeError):
        MK.segmented_scan(pts, pts, flags, flags, 16)
    coords = _fake_cuda((16, 2, 8))
    with pytest.raises(RuntimeError):
        EK.ec_fft(coords, coords, coords, _fake_cuda((2, 7, 2, EK.DIGITS), torch.int8),
                  _fake_cuda((2, 2, EK.DIGITS), torch.int8))


def test_wrappers_reject_other_devices():
    meta = torch.empty((2, 16, 8), dtype=FT.DTYPE, device="meta")
    with pytest.raises(ValueError):
        PK.hash_batch(meta)
    with pytest.raises(ValueError):
        PK.permute(meta[0], meta[1])
    with pytest.raises(ValueError):
        PM.hash_batch_mxu(meta)
    with pytest.raises(ValueError):
        EXP.run("vpu_mul", meta[0], meta[1], 1)
    coords = torch.empty((16, 1, 4), dtype=FT.DTYPE, device="meta")
    with pytest.raises(ValueError):
        EK.ec_fft(coords, coords, coords, torch.empty((16, 1, 3), dtype=FT.DTYPE, device="meta"))


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
