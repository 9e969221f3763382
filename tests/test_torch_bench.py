"""The port's bench entry points (``circuits_halo2_tpu_torch.bench_suite``
and ``.bench``) on the CPU at tiny sizes, against the JAX package's root
``bench_suite.py``: the tree stage's metric names, units and fields equal
the JAX ``bench_build``'s at 2^4 leaves and so does its root for the same
seed; a failing stage is reported and the others run; without a card and
without ``--device cpu`` both entry points raise; the prove measurement
(phases, profile summary) and, as a ``slow`` case, the k=11 keygen, prove
and verify stages with the fixture's bytes. The JAX stage functions are
called directly, never the JAX ``main()``; the MSM, NTT and headline
stages are in ``test_torch_bench_kernels.py``."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import bench_suite as jax_bench_suite
from circuits_halo2_tpu_torch import bench as BH
from circuits_halo2_tpu_torch import bench_suite as BS
from circuits_halo2_tpu_torch.ops import ntt as NTT

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TREE_LOG2, NTT_LOG2 = 4, 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_build():
    """The JAX ``bench_build``'s root and JSON lines at 2^4 leaves."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        root = jax_bench_suite.bench_build(TREE_LOG2)
    return root, parse_lines(buf.getvalue())


@pytest.fixture(scope="module")
def port_build():
    """The port's ``bench_build`` at the same size, one warm repeat (each
    gate is checked before its line is emitted)."""
    bench = BS.Bench(CPU, 1)
    root = BS.bench_build(bench, TREE_LOG2)
    return root, {line["metric"]: line for line in bench.lines}


def parse_lines(text: str) -> dict:
    lines = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    return {line["metric"]: line for line in lines}


def check_line(got: dict, want: dict) -> None:
    """A port ``s`` line against the JAX stage's line of the same metric."""
    assert got["unit"] == want["unit"] == "s"
    assert set(want) <= set(got), set(want) - set(got)
    assert got["device"] == "cpu" and got["power_limit_w"] is None
    assert got["min_s"] <= got["value"] == got["median_s"] <= got["max_s"]
    assert got["repeats"] == 1 and got["cold_s"] > 0


@pytest.mark.parametrize("metric", [f"mst_build_2^{TREE_LOG2}", f"mst_build_sorted_2^{TREE_LOG2}"])
def test_build_lines_match_jax(metric, jax_build, port_build):
    check_line(port_build[1][metric], jax_build[1][metric])


def test_build_root_equals_jax(jax_build, port_build):
    assert port_build[0] == jax_build[0]


def test_failing_stage_is_reported_and_others_run(monkeypatch, capsys):
    """A stage that raises is named, its traceback printed, the next stage
    still runs, and ``main`` exits 1; a broken host reference fails its gate."""
    bench = BS.Bench(CPU, 1)

    def broken(*args):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(BS, "bench_msm", broken)
    env = {"BENCH_NTT_LOG2": str(NTT_LOG2), "BENCH_NTT_ITERS": "2"}
    assert BS.run(bench, ["msm", "ntt"], env) == ["msm"]
    assert [line["metric"] for line in bench.lines] == [f"ntt_2^{NTT_LOG2}"]
    err = capsys.readouterr().err
    assert "stage msm FAILED" in err and "broken on purpose" in err and "Traceback" in err

    monkeypatch.setattr(NTT, "ntt_host", lambda a, omega: [0] * len(a))
    with pytest.raises(BS.GateError):
        BS.bench_ntt(bench, NTT_LOG2, 2)
    monkeypatch.setenv("BENCH_STAGES", "ntt")
    monkeypatch.setenv("BENCH_NTT_LOG2", str(NTT_LOG2))
    monkeypatch.setenv("BENCH_REPEATS", "1")
    assert BS.main(["--device", "cpu"]) == 1


def test_stage_names():
    assert BS.parse_stages("all") == list(BS.STAGES)
    assert BS.parse_stages("verify,build") == ["build", "verify"]
    assert {"criterion", "northstar", "batch_throughput"} <= set(BS.STAGES)
    with pytest.raises(ValueError):
        BS.parse_stages("build,tunnel")
    with pytest.raises(ValueError):
        BS.Bench(CPU, 0)


@pytest.mark.parametrize("module", ["bench_suite", "bench"])
def test_no_card_without_device_cpu_raises(module, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    monkeypatch.setenv("BENCH_STAGES", "ntt")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        {"bench_suite": BS, "bench": BH}[module].main([])
    proc = subprocess.run([sys.executable, "-m", f"circuits_halo2_tpu_torch.{module}"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=os.environ | {"BENCH_STAGES": "ntt"})
    assert proc.returncode != 0
    assert '"metric"' not in proc.stdout


def _event(kind, name, start_us, end_us):
    """A stand-in for one of the profiler's raw events."""
    return SimpleNamespace(device_type=lambda: kind, name=lambda: name,
                           start_ns=lambda: start_us * 1000, end_ns=lambda: end_us * 1000)


def test_profile_summary():
    """Busy time is the union of device intervals (copies included), the
    kernel count leaves copies out, and the top kernels sum by name."""
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_event(cpu, "aten::mul", 0, 1000), _event(cuda, "mul_kernel", 0, 100),
              _event(cuda, "mul_kernel", 50, 150), _event(cuda, "Memcpy HtoD", 400, 500),
              _event(cuda, "add_kernel", 600, 610), _event(cuda, "scan", 700, 1000)]
    got = BS.profile_summary(events, wall_s=0.002)
    assert got["device_busy_s"] == pytest.approx(560e-6)
    assert got["idle_share"] == pytest.approx(1 - 0.28)
    assert got["launches"] == 4
    assert [(k["name"], k["launches"]) for k in got["top_kernels"]] == [
        ("scan", 1), ("mul_kernel", 2), ("add_kernel", 1)]
    assert got["top_kernels"][1]["device_s"] == pytest.approx(200e-6)
    assert BS.profile_summary(events[:1], 1.0) == {"profiler": "no device events"}
    # the raw events of a real (CPU-only) profile
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8) + 1
    raw = prof.profiler.kineto_results.events()
    assert raw and all(e.end_ns() >= e.start_ns() for e in raw)
    assert BS.profile_summary(raw, 1.0) == {"profiler": "no device events"}


def test_measure_prove_traces_phases():
    """The timed repeats run with the prove trace off; one more prove, not
    timed, runs with it on and gives the phases; a prove whose bytes change
    fails."""
    calls = []

    def prove():
        calls.append(os.environ.get("CIRCUITS_PROVE_TRACE"))
        if calls[-1]:
            print(f"[prove] phase1 synth: {0.5 * len(calls):.3f}s", file=sys.stderr)
            print("[prove] phase2 lookup: 0.250s", file=sys.stderr)
        return b"proof"

    bench = BS.Bench(CPU, 3)
    proof, timing, extra = BS.measure_prove(bench, prove)
    assert proof == b"proof" and len(timing.warm) == 3
    assert calls == [None, None, None, None, "1"]
    assert extra["phases_s"] == {"phase1 synth": 2.5, "phase2 lookup": 0.25}
    assert extra["traced_s"] > 0
    assert extra["peak_mem_bytes"] is None and extra["profiler"] == "cpu run"
    counter = iter(range(10))
    with pytest.raises(BS.GateError):
        BS.measure_prove(bench, lambda: bytes([next(counter)]))


@pytest.mark.slow
def test_k11_stages_equal_the_fixture():
    """Stage 4 once with one warm repeat: keygen, the prove (its Blake2b
    bytes equal tests/fixtures_torch_proofs.json's) and the verify."""
    bench = BS.Bench(CPU, 1)
    assert BS.run(bench, ["keygen", "prove", "verify"], {}) == []
    lines = {line["metric"]: line for line in bench.lines}
    assert set(lines) == {"keygen_vk_pk_k11", "prove_mst_inclusion_k11",
                          "verify_mst_inclusion_k11"}
    prove = lines["prove_mst_inclusion_k11"]
    assert prove["proof_bytes"] == 1632 and prove["phases_s"]
    assert lines["verify_mst_inclusion_k11"]["ok"] is True
