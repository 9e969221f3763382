"""The port's tracing module (``utils/tracing``): spans nest with their
parents, calls and users; nothing is recorded while it is off; counts add
up; a prover phase prints its ``CIRCUITS_PROVE_TRACE`` line. The traced
CPU prove (the batch prover's k=11 fixture) is checked in
``test_torch_batch.py``.

The ``cuda`` case holds the module to the benchmark's traced run on the
card: a span around an idle gap between two kernels receives that gap on
the profiler's clock, and the work of the module's kernel counts equals
the benchmark's wrappers' (``benchmark/trace.Wrappers``, ``benchmark/work``)
for K1, K3 and X0, with launches equal to the ``.launches`` increments:

    CIRCUITS_TPU_NO_CACHE=1 python -m pytest tests/test_torch_tracing.py -o addopts="" -m cuda -q -s
"""

import io
import statistics
import sys
import time

import numpy as np
import pytest
import torch

from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.merkle import device_tree as TDT
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import msm as TM
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.ops import ntt as NTT
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
from circuits_halo2_tpu_torch.utils import tracing as TR


@pytest.fixture
def recording():
    TR.drain()
    TR.enable()
    try:
        yield
    finally:
        TR.disable()
        TR.drain()


def test_spans_nest_with_parents_calls_and_users(recording):
    with TR.call() as first:
        with TR.span("outer") as outer:
            with TR.span("per_user", 3) as per_user:
                with TR.span("inner") as inner:
                    pass
            with TR.span("other_user", 5):
                pass
    with TR.call() as second:
        with TR.span("next_call"):
            pass
    with TR.span("no_call"):
        pass
    spans, counts = TR.drain()
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["inner", "per_user", "other_user", "outer", "next_call",
                                       "no_call"]
    assert first != second and counts == {}
    assert by["outer"].parent is None and by["per_user"].parent == outer.id
    assert by["inner"].parent == per_user.id and by["other_user"].parent == outer.id
    assert [by[k].call for k in ("outer", "per_user", "inner", "other_user")] == [first] * 4
    assert by["next_call"].call == second and by["no_call"].call is None
    assert (by["outer"].user, by["per_user"].user, by["inner"].user,
            by["other_user"].user) == (None, 3, 3, 5)
    assert outer.start <= per_user.start <= inner.start <= inner.end <= per_user.end <= outer.end
    assert len({s.id for s in spans}) == len(spans)


def test_off_records_nothing():
    TR.drain()
    assert not TR.on
    first, second = TR.span("a", 1), TR.call()
    assert first is second is TR.span("b")
    with TR.call(), TR.span("a"), TR.phase("phase1 synth+advice commits"):
        TR.count("kernel", "X0a", launches=1, elements=4)
    assert TR.drain() == ([], {})


def test_counts_add_up(recording):
    TR.count("kernel", "X0a", launches=1, elements=8, operands=9)
    TR.count("kernel", "X0a", launches=1, elements=2)
    TR.count("kernel", "K1", launches=1, messages=4, elements=12)
    TR.count("copy", "poly_device", h2d_bytes=128)
    TR.count("copy", "poly_device", h2d_bytes=256)
    _, counts = TR.drain()
    assert counts == {("kernel", "X0a"): {"launches": 2, "elements": 10, "operands": 9},
                      ("kernel", "K1"): {"launches": 1, "messages": 4, "elements": 12},
                      ("copy", "poly_device"): {"h2d_bytes": 384}}
    assert TR.drain() == ([], {})


def test_own_elements_counts_a_broadcast_axis_once():
    a = torch.zeros((16, 3, 1, 8), dtype=torch.int64)
    assert TR.own_elements(a) == 24
    assert TR.own_elements(a.expand(16, 3, 5, 8)) == 24
    assert TR.own_elements(a[:, :, :, ::2]) == 12
    assert TR.own_elements(torch.zeros(16, dtype=torch.int64)) == 1


@pytest.mark.parametrize("record", [False, True])
def test_a_phase_prints_its_line_and_is_a_span(monkeypatch, record):
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    TR.drain()
    if record:
        TR.enable()
    try:
        with TR.phase("phase4 quotient+commit", torch.device("cpu")):
            with TR.span("dispatch"):
                time.sleep(0.002)
    finally:
        TR.disable()
    spans, _ = TR.drain()
    line = err.getvalue()
    assert line.startswith("[prove] phase4 quotient+commit: ") and line.endswith("s\n")
    assert float(line.rsplit(": ", 1)[1][:-2]) >= 0.002
    if record:
        dispatch, phase = spans
        assert phase.name == "phase4 quotient+commit" and dispatch.parent == phase.id
    else:
        assert spans == []


def test_a_failed_phase_prints_nothing(monkeypatch):
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    with pytest.raises(ValueError):
        with TR.phase("phase5 evaluations", torch.device("cpu")):
            raise ValueError("quotient degree overflow")
    assert err.getvalue() == ""


# ---------------------------------------------------------------------------
# On the card: the clock and the counters against the benchmark's traced run
# ---------------------------------------------------------------------------

def _x0_work(W, counts):
    wide = nbytes = 0
    for key, per in (("X0a", W.MUL), ("X0b", 0)):
        c = counts.get(("kernel", key), {})
        wide += c.get("elements", 0) * per
        nbytes += W.LIMB_FE * (c.get("elements", 0) + c.get("operands", 0))
    return [wide, nbytes]


def _k1_work(W, counts):
    c = counts[("kernel", "K1")]
    return [c["elements"] * W.PERM_WIDE, W.LIMB_FE * (c["elements"] + c["messages"])]


@pytest.mark.cuda
def test_spans_share_the_profiler_clock_and_counts_equal_the_wrappers():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from benchmark import trace as BT
    from benchmark import work as W

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(16)

    def limbs(shape):
        vals = [int.from_bytes(rng.bytes(32), "little") % FT.FR.mod_int
                for _ in range(int(np.prod(shape)))]
        return torch.as_tensor(FT.to_mont_limbs(vals).reshape((16,) + shape), device=dev)

    a, b = limbs((4, 1 << 12)), limbs((1, 1 << 12))
    points = native.g1_fixed_base_muls((1, 2), [int(v) for v in rng.integers(1, 10**9, 1 << 10)])
    rows = [[int.from_bytes(rng.bytes(32), "little") % FT.FR.mod_int for _ in range(1 << 10)]
            for _ in range(3)]
    digests = rng.integers(0, 256, size=(1 << 10, 32), dtype=np.uint8)
    balances = rng.integers(0, 1 << 40, size=(1 << 10, 1), dtype=np.uint64)

    def work():
        FT.mont_mul(a, b.expand(16, 4, 1 << 12))
        FT.neg_mod(a[:, :, ::2])
        FT.sub_mod(a, b)
        FT.inv_mont(a[:, :1, :8])
        TM.msm_auto_batch(points, rows, dev)
        TDT.build_device_tree(digests, balances, dev).root()
        NTT.ntt(a, NTT.omega_for_k(12))

    work()  # every kernel built and warm
    attrs = [(FT, "mont_mul"), (FT, "linear"), (FT, "inv_mont"), (MK, "segmented_scan"),
             (PK, "hash_batch"), (NTT, "ntt_passes")]
    before = [getattr(m, n).launches for m, n in attrs]
    tracer = BT.Tracer(dev)
    TR.drain()
    tracer.start()
    TR.enable()
    try:
        # the clock: kernels launched one at a time onto an idle card
        stamps = []
        for _ in range(20):
            torch.cuda.synchronize(dev)
            stamps.append(time.perf_counter_ns())
            FT.mont_mul(a, b)
        torch.cuda.synchronize(dev)
        with TR.span("idle_sleep"):
            time.sleep(0.02)
        FT.mont_mul(a, b)
        torch.cuda.synchronize(dev)
        work()
        torch.cuda.synchronize(dev)
    finally:
        TR.disable()
        tracer.stop()
    spans, counts = TR.drain()
    after = [getattr(m, n).launches for m, n in attrs]
    tracer.spans.items += [(s.start, s.end, s.name) for s in spans]
    trace = tracer.result(W.card(0), {})

    # the clock: the profiler stamps the card's activity on the wall clock
    # (time_ns), the spans are on perf_counter_ns (CLOCK_MONOTONIC, as is
    # monotonic_ns); the benchmark's offset is the marker kernel's start less
    # the host's mark, so its error is the marker's launch latency
    from torch.autograd import DeviceType

    events = tracer.prof.profiler.kineto_results.events()
    starts = sorted(e.start_ns() for e in events if e.device_type() == DeviceType.CUDA
                    and BT.HAND_KERNELS["X0a"] in e.name())[:20]
    offset = min(x for x, _ in BT.profile_summary(events)["intervals"]) - tracer.mark_ns
    error = offset - (time.time_ns() - time.perf_counter_ns())
    lag = [s - (offset - error) - h for s, h in zip(starts, stamps)]
    print(f"\nclock: offset {offset} ns, its error (less the wall clock's offset from "
          f"perf_counter_ns) {error} ns; perf_counter_ns - monotonic_ns "
          f"{time.perf_counter_ns() - time.monotonic_ns()} ns; each kernel's start less its "
          f"host stamp (the call's Python and the launch): min {min(lag)} ns, median "
          f"{statistics.median(lag)} ns, max {max(lag)} ns; the idle gap given to the span "
          f"{trace.gaps.get('idle_sleep', 0.0):.6f} s")
    assert abs(time.perf_counter_ns() - time.monotonic_ns()) < 10**6
    assert 0 <= error < 2_000_000 and 0 < min(lag) and max(lag) < 2_000_000
    assert 0.02 <= trace.gaps["idle_sleep"] < 0.025

    # the counters
    counted = {"x0": _x0_work(W, counts), "k3": list(W.k3_work(counts[("kernel", "K3")]["points"])),
               "k1": _k1_work(W, counts)}
    print(f"work: wrappers {trace.work}, counters {counted}")
    assert counted == {k: trace.work[k] for k in counted}
    launches = {key: c["launches"] for (name, key), c in counts.items() if name == "kernel"}
    assert [launches.get(k, 0) for k in ("X0a", "X0b", "X0c", "K3", "K1", "X1")] == \
        [y - x for x, y in zip(before, after)]
    assert counts[("copy", "device_tree")]["h2d_bytes"] == 2 * 16 * 8 * (1 << 10)
