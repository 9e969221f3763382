"""CPU tests of the benchmark's harness and reference.

    python -m pytest benchmark/tests -q

The cells run here at a tiny size (``tiny_root``: a copy of the benchmark
with a 4-leaf configuration at k=10 and U=2) through ``run.execute`` on the
CPU, the harness's look for a card skipped; the tests marked ``cuda`` run a
cell on the card and skip without one.
"""

from __future__ import annotations

import json
import random
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import imports, run, spec, traffic as T, work as W
from benchmark import trace as TR
from benchmark.reference import keygen as RK
from benchmark.reference import verifier as RV
from benchmark.reference.tree import Tree

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CPU_CARD = W.Card("cpu", 1, 1000.0, 0.0)
SEED = 2**31 + 11


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)


def tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark with the cells ``tiny-bulk`` and
    ``tiny-snapshot``, added as files and entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    s = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "benchmark/configs/criterion.json").read_text())
    conf.update(name="tiny", levels=2, k=10)
    (tmp_path / "benchmark/configs/tiny.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "benchmark/traffic/bulk-u16.json").read_text())
    mix["users_per_call"] = 2
    (tmp_path / "benchmark/traffic/bulk-u2.json").write_text(json.dumps(mix))
    s["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                         "file": "benchmark/configs/tiny.json", "reduced": [], "why": "tests"})
    s["workloads"] += [
        {"name": "tiny-bulk", "config": "tiny", "traffic": "bulk-u2", "chips": 1, "why": "tests"},
        {"name": "tiny-snapshot", "config": "tiny", "traffic": "snapshot-2", "chips": 1,
         "why": "tests"}]
    for m in s["end_to_end"] + s["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny-bulk" if "criterion-bulk" in m["workloads"]
                                  else "tiny-snapshot")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    return tmp_path


def execute(root: Path, cell: str, fault=None, seconds=0.5) -> dict:
    return run.execute(spec.cell(cell, root), SEED, seconds, False, "cpu", fault=fault,
                       card=CPU_CARD)


# ---------------------------------------------------------------------------
# BENCHMARK.json and discovery by name
# ---------------------------------------------------------------------------

def test_benchmark_json_keeps_the_contract_shape():
    raw = (ROOT / "BENCHMARK.json").read_text()
    s = json.loads(raw)
    assert len(raw.encode()) <= 64 * 1024
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= s["run_seconds"] <= 51 and s["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in s["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        c = spec.cell(w["name"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
        for m in c.per_layer:
            assert m["moves"] in reported


def test_every_cell_finds_its_files_by_name():
    s = spec.load()
    for w in s["workloads"]:
        c = spec.cell(w["name"])
        assert hasattr(spec.loop(c.traffic), "Loop")
        for m in c.per_layer:
            assert callable(spec.reader(m["name"]))
    for conf in s["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]


def test_a_config_mix_and_metric_are_added_by_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    s = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "benchmark/traffic/snapshot-2.json").read_text())
    mix.update(balance_arrays=3)
    (root / "benchmark/traffic/snapshot-3.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/builds_seen.snapshot.py").write_text(
        "def read(t):\n    return t.counts.get('builds') or None\n")
    s["workloads"].append({"name": "dummy", "config": "tiny", "traffic": "snapshot-3",
                           "chips": 1, "why": "a mix added as data"})
    s["per_layer"].append({"name": "builds_seen.snapshot", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "snapshot_s", "workloads": ["dummy"]})
    for m in s["end_to_end"]:
        if m["name"] == "snapshot_s":
            m["workloads"].append("dummy")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    c = spec.cell("dummy", root)
    assert [m["name"] for m in c.per_layer] == ["builds_seen.snapshot"]
    assert {m["name"] for m in c.end_to_end} == {"snapshot_s", "setup_s"}
    assert spec.reader("builds_seen.snapshot", root)(types.SimpleNamespace(counts={"builds": 4})) == 4
    result = execute(root, "dummy")
    assert result["correct"] and set(result["metrics"]) == {"snapshot_s", "setup_s"}


# ---------------------------------------------------------------------------
# The window's arithmetic
# ---------------------------------------------------------------------------

class _SlowLoop:
    kind = "prove"

    def __init__(self, *args):
        self.proofs = 0

    def setup(self):
        pass

    def step(self):
        time.sleep(0.2)
        self.proofs += 3

    def end_to_end(self, elapsed):
        self.elapsed = elapsed
        return {"proofs_per_s": self.proofs / elapsed}

    def counts(self):
        return {"proofs": self.proofs}

    def free(self):
        pass

    def judge(self):
        return {"x": (0, 0)}, self.proofs, 0


def test_the_rate_is_over_whole_calls(monkeypatch):
    made = []

    def loop(_traffic):
        return types.SimpleNamespace(Loop=lambda *a: made.append(_SlowLoop()) or made[-1])

    monkeypatch.setattr(spec, "loop", loop)
    result = run.execute(spec.cell("criterion-bulk"), 1, 0.5, False, "cpu", card=CPU_CARD)
    slow = made[0]
    assert slow.proofs == 9  # three calls: the third is the first to end after 0.5 s
    assert 0.6 <= slow.elapsed < 0.9
    assert result["metrics"]["proofs_per_s"]["value"] == pytest.approx(9 / slow.elapsed)
    assert result["correct"] and list(result["checks"]) == ["x"]


def test_busy_is_the_union_of_overlapping_intervals():
    total, merged = TR.busy_union([(0, 10), (5, 20), (30, 40), (35, 36), (40, 41)])
    assert total == 31 and merged == [(0, 20), (30, 41)]
    assert TR.busy_union([]) == (0, [])


def test_idle_gaps_go_to_the_innermost_host_span():
    tracer = TR.Tracer.__new__(TR.Tracer)
    tracer.spans = TR.Spans()
    tracer.spans.items = [(0, 100, "prove_batch"), (100, 130, "paths+circuits")]
    tracer.lines = TR.StampedLines()
    tracer.lines.lines = [(40, "[prove] phase1 synth+advice commits: 0.000040s"),
                          (90, "[prove] phase2 lookup permute+commit: 0.000050s")]
    # device busy [5, 10), [60, 95) and [120, 125) of a window [0, 140), clocks offset by 1000
    gaps = tracer._gaps([(1005, 1010), (1060, 1095), (1120, 1125)], 1000, 1140, 1000)
    assert gaps == pytest.approx({"phase1 synth+advice commits": 55e-9,
                                  "paths+circuits": 25e-9, "harness": 15e-9})


def test_phase_lines_are_stamped_and_summed():
    lines = TR.StampedLines()
    lines.write("[prove] phase1 synth+advice commits: 1.500s\n[prove] phase3 grand")
    lines.write(" products+commits: 0.250s\n")
    assert [x[1] for x in lines.lines] == ["[prove] phase1 synth+advice commits: 1.500s",
                                            "[prove] phase3 grand products+commits: 0.250s"]


# ---------------------------------------------------------------------------
# Roofline work, by hand
# ---------------------------------------------------------------------------

def test_x0_work_counts_own_elements_once():
    a = torch.zeros((16, 1, 8, 64), dtype=torch.int64)
    b = torch.zeros((16, 1, 1, 64), dtype=torch.int64).expand(16, 1, 8, 64)
    out = torch.zeros((16, 1, 8, 64), dtype=torch.int64)
    wide, nbytes = W.x0_work(W.MUL, out, a, b)
    assert wide == 512 * 132 and nbytes == 128 * (512 + 512 + 64)
    assert W.x0_work(0, out, a) == (0, 128 * 1024)


def test_k1_k3_work_and_the_card_rate():
    assert W.PERM_WIDE == 49_568 and W.K3_BYTES == 649
    assert W.k1_work(2, 1 << 20) == (2 * 49_568 << 20, 3 * 128 << 20)
    assert W.k3_work(4096) == (0, 4096 * 649)
    h100 = W.Card("H100", 132, 1980.0, 700.0)
    # a mixed add a point (7 products, 4 squarings) never outweighs K3's bytes
    madd = 7 * W.MUL + 4 * W.SQR
    assert madd == 1_340 and W.least_s(4096 * madd, 4096 * 649, h100.wide_per_s)[1] == "bytes"
    assert h100.wide_per_s == pytest.approx(132 * 64 * 1.98e9 / 2)
    assert W.least_s(8.3635e12, 0, h100.wide_per_s) == (pytest.approx(1.0, rel=1e-4), "operations")
    assert W.least_s(0, 3.35e12, h100.wide_per_s) == (pytest.approx(1.0), "bytes")


def test_a_roofline_share_is_least_time_over_device_time():
    h100 = W.Card("H100", 132, 1980.0, 700.0)
    t = TR.Trace(1.0, 0.5, {"void x0::mont_mul_kernel<...>(...)": [10, 2_000_000],
                            "linear_kernel(int)": [5, 2_000_000]},
                 {"proofs": 1}, {}, {"x0": [0, int(3.35e12 * 0.002)]}, 0, h100)
    assert t.roofline("x0", "X0a", "X0b") == pytest.approx(50.0)
    assert t.device_s("X0a") == pytest.approx(0.002) and t.roofline("k3", "K3") is None


# ---------------------------------------------------------------------------
# What a run may load
# ---------------------------------------------------------------------------

def test_forbidden_names_are_compared_whole():
    mods = {"circuits_halo2_tpu_torch.ops.ntt": 1, "circuits_halo2_tpu.ops.ntt": 1,
            "jaxlib": 1, "jax_plugins_like": 1, "flax.linen": 1, "numpy": 1}
    assert imports.forbidden(mods) == ["circuits_halo2_tpu.ops.ntt", "flax.linen", "jaxlib"]


def test_the_harness_and_the_reference_load_no_forbidden_module():
    code = """
import importlib, json, pathlib, sys
import benchmark.run, benchmark.faults, benchmark.trace, benchmark.work
from benchmark import spec
import benchmark.reference.tree, benchmark.reference.keygen, benchmark.reference.verifier
ref_only = sorted(m for m in sys.modules if m.split('.')[0] == 'circuits_halo2_tpu_torch')
for w in spec.load()['workloads']:
    cell = spec.cell(w['name'])
    spec.loop(cell.traffic)
    for m in cell.per_layer:
        spec.reader(m['name'])
import circuits_halo2_tpu_torch.utils.pipeline, circuits_halo2_tpu_torch.models.prover_batch
import circuits_halo2_tpu_torch.merkle.device_tree, circuits_halo2_tpu_torch.merkle.mst
import circuits_halo2_tpu_torch.ops.msm_kernel, circuits_halo2_tpu_torch.ops.poseidon_kernel
from benchmark import imports
print(json.dumps([ref_only, imports.forbidden()]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    ref_only, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref_only == [] and bad == []


# ---------------------------------------------------------------------------
# The reference against the port's plain CPU route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ncur,host_max", [(16, 2, 1 << 9), (64, 1, 4), (32, 2, 1)])
def test_reference_tree_equals_the_port(monkeypatch, n, ncur, host_max):
    from circuits_halo2_tpu_torch.merkle.device_tree import build_device_tree
    from benchmark.reference import tree as RT

    monkeypatch.setattr(RT, "HOST_MAX", host_max)
    rng = np.random.default_rng(n)
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    balances = rng.integers(0, 1 << 48, size=(n, ncur), dtype=np.uint64)
    ref = Tree(digests, balances, "cpu")
    port = build_device_tree(digests, balances, "cpu")
    assert ref.root() == port.root()
    for u in (0, n - 1, n // 3):
        proof = port.generate_proof(u, T.entry(digests, balances, u))
        want = ref.path(u)
        assert proof.sibling_leaf_node_hash_preimage == want["sibling_leaf"]
        assert proof.sibling_middle_node_hash_preimages == want["sibling_middles"]
        assert proof.path_indices == want["path"] and proof.root.hash == want["root_hash"]


def test_reference_on_the_entry_16_fixture():
    """The k=11 fixture's tree (4 levels, 2 currencies), its verifying key
    on the unsafe setup, and a port proof checked by the reference."""
    from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.utils import pipeline

    tree = MerkleSumTree.from_csv(str(ROOT / "tests/fixtures_csv/entry_16.csv"), "cpu")
    entries = tree.entries
    digests = np.stack([np.frombuffer(e.hashed_username.to_bytes(32, "big"), dtype=np.uint8)
                        for e in entries])
    balances = np.array([e.balances for e in entries], dtype=np.uint64)
    ref = Tree(digests, balances, "cpu")
    assert ref.root() == (tree.root.hash, tree.root.balances)
    vk = RK.verifying_key(4, 2, 8, 11)
    art = pipeline.generate_setup_artifacts(11, None, 4, 2, 8, "cpu")
    assert vk.fixed_commitments == art.vk.fixed_commitments
    assert vk.permutation_commitments == art.vk.permutation_commitments
    assert vk.transcript_repr == art.vk.transcript_repr
    circuit = MstInclusionCircuit.init(4, 2, 8, tree.generate_proof(5))
    want = ref.path(5)
    inst = [[want["leaf_hash"], want["root_hash"]] + want["root_balances"]]
    assert circuit.instances() == inst
    proof = pipeline.full_prover(art, circuit, inst)
    rng = random.Random(3)
    assert RV.check([RV.verify(vk, inst, proof)], rng)
    flipped = bytearray(proof)
    flipped[200] ^= 4
    try:
        assert not RV.check([RV.verify(vk, inst, bytes(flipped))], rng)
    except ValueError:
        pass
    other = [[inst[0][0], inst[0][1], inst[0][2] + 1, inst[0][3]]]
    assert not RV.check([RV.verify(vk, other, proof)], rng)
    with pytest.raises(ValueError):
        RV.verify(vk, inst, proof + b"\0")


def test_a_wrong_root_or_key_from_the_set_up_is_counted(tmp_path):
    """The checks no fault of the window reaches: the set-up's root and
    verifying key, judged against the reference with no proof made."""
    from benchmark.loops.prove_batch import Loop

    cell = spec.cell("tiny-bulk", tiny_root(tmp_path))
    loop = Loop(cell, SEED, torch.device("cpu"), TR.Spans())
    loop.digests, loop.balances = T.leaves(loop.rngs["leaves"], cell.config)
    vk = RK.verifying_key(2, 1, 8, 10)
    root = Tree(loop.digests, loop.balances, "cpu").root()
    loop.root = (root[0] + 1, root[1])
    loop.program_vk = (vk.fixed_commitments[:-1] + [None], vk.permutation_commitments,
                      vk.transcript_repr)
    checks, attempted, failed = loop.judge()
    assert checks["root_mismatch"] == (1, 0) and checks["vk_mismatch"] == (1, 0)
    assert (attempted, failed) == (0, 0) and checks["proofs_failed"] == (0, 0)


# ---------------------------------------------------------------------------
# Whole runs at a tiny size: sound, the control, and each fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["tiny-snapshot", "tiny-bulk"])
@pytest.mark.parametrize("fault", [None, "understate", "stale", "half", "altered"])
def test_a_run_is_correct_only_when_the_timed_path_is(tmp_path, cell, fault):
    """``understate`` is the control (a liability one lower than the
    snapshot's); the other faults break the timed path underneath."""
    result = execute(tiny_root(tmp_path), cell, fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] >= 1 and (result["failed"] == 0) is (fault is None)
    assert list(result)[-3:] == ["checks", "forbidden", "card"]
    assert result["forbidden"] == []


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "criterion-snapshot", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["kind"] == card
    assert list(result)[-1] == "checks"
