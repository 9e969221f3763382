"""The traced run (``--trace 1``): device activity, host spans, phase lines
and the work of each hand-kernel call, over the same whole calls.

- Device: ``torch.profiler`` records CUDA activity only over the window
  (recording host ops too made a k=11 prove 6x slower in the port's bench);
  the raw kineto events are read. Busy time is the union of the CUDA
  intervals (``profile_summary``, copied from the port's
  ``bench_suite.profile_summary``).
- Host: the loops' spans (``Spans``) and the prover's phase lines
  (``CIRCUITS_PROVE_TRACE=1``, whose clock synchronises the card at each
  mark: it perturbs the times, so it is on in the traced run only), each
  line stamped as it is written.
- Work: the benchmark wraps ``msm_kernel.segmented_scan`` (K3),
  ``field_torch.mont_mul`` / ``linear`` (X0a, X0b) and
  ``poseidon_kernel.hash_batch`` (K1) for the traced window only, and
  records what each launching call's arguments need (``work.py``).
  ``Wrappers.remove`` puts the module attributes back.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time
from dataclasses import dataclass, field

from . import work as W

# the port's hand kernels, by the name of their CUDA function (csrc/*.cu)
HAND_KERNELS = {"K1": "poseidon_sponge_kernel", "K2": "poseidon_permute_kernel",
                "K3": "msm_scan_kernel", "K4": "poseidon_mxu_sponge_kernel",
                "X4": "ec_fft_stage_kernel", "X0a": "mont_mul_kernel", "X0b": "linear_kernel",
                "X0c": "inv_kernel", "X1": "ntt_pass_kernel"}
PHASE_LINE = re.compile(r"\[prove\] (.+): ([0-9.]+)s$")
TOP = 10


def busy_union(intervals) -> tuple[int, list[tuple[int, int]]]:
    """(total ns covered, merged intervals) of (start, stop) pairs."""
    merged: list[list[int]] = []
    for start, stop in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def profile_summary(events) -> dict:
    """Device intervals and per-kernel launches and nanoseconds from the
    profiler's raw events (each with ``name()``, ``device_type()``,
    ``start_ns()``, ``end_ns()``); copies and sets count as busy, not as
    kernels."""
    from torch.autograd import DeviceType

    device = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if e.device_type() == DeviceType.CUDA]
    per_name: dict[str, list[int]] = {}
    for start, stop, name in device:
        if name.startswith(("Memcpy", "Memset")):
            continue
        entry = per_name.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += stop - start
    return {"intervals": [(a, b) for a, b, _ in device], "kernels": per_name}


class Spans:
    """Host spans of the window on ``perf_counter_ns``: (start, stop, name)."""

    def __init__(self):
        self.items: list[tuple[int, int, str]] = []
        self.on = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((t0, time.perf_counter_ns(), name))


class StampedLines:
    """A stand-in for ``sys.stderr`` that keeps each line with the
    ``perf_counter_ns`` at which it was written."""

    def __init__(self):
        self.lines: list[tuple[int, str]] = []
        self._part = ""

    def write(self, text: str) -> int:
        now = time.perf_counter_ns()
        self._part += text
        *done, self._part = self._part.split("\n")
        self.lines.extend((now, line) for line in done)
        return len(text)

    def flush(self) -> None:
        pass


class Wrappers:
    """Records the work of every launching call of the wrapped kernels."""

    def __init__(self):
        self.work: dict[str, list[int]] = {}
        self._installed = []

    def _add(self, key: str, wide: int, nbytes: int) -> None:
        entry = self.work.setdefault(key, [0, 0])
        entry[0] += wide
        entry[1] += nbytes

    def _wrap(self, module, attr: str, after) -> None:
        orig = getattr(module, attr)

        def wrapper(*args, **kwargs):
            before = wrapper.launches
            out = orig(*args, **kwargs)
            if wrapper.launches != before:
                after(out, *args, **kwargs)
            return out

        wrapper.launches = orig.launches
        setattr(module, attr, wrapper)
        self._installed.append((module, attr, orig, wrapper))

    def install(self) -> None:
        from circuits_halo2_tpu_torch.ops import field_torch as FT
        from circuits_halo2_tpu_torch.ops import msm_kernel as MK
        from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK

        def mont_mul(out, a, b, *_, **__):
            self._add("x0", *W.x0_work(W.MUL, out, a, b))

        def linear(out, op, a, b, *_, **__):
            self._add("x0", *W.x0_work(0, out, *((a,) if op == FT.NEG else (a, b))))

        def scan(out, px, py, pvalid, seg, *_, **__):
            self._add("k3", *W.k3_work(seg.numel()))

        def hash_batch(out, inputs, *_, **__):
            self._add("k1", *W.k1_work(inputs.shape[0], inputs.shape[2]))

        self._wrap(FT, "mont_mul", mont_mul)
        self._wrap(FT, "linear", linear)
        self._wrap(MK, "segmented_scan", scan)
        self._wrap(PK, "hash_batch", hash_batch)

    def remove(self) -> None:
        while self._installed:
            module, attr, orig, wrapper = self._installed.pop()
            orig.launches = wrapper.launches
            setattr(module, attr, orig)


@dataclass
class Trace:
    """What the per-layer readers read: one traced window of whole calls."""

    window_s: float
    busy_s: float
    kernels: dict[str, list[int]]
    counts: dict[str, int]
    phases: dict[str, float]
    work: dict[str, list[int]]
    peak_bytes: int
    card: W.Card
    gaps: dict[str, float] = field(default_factory=dict)

    def launches(self) -> int:
        return sum(c for c, _ in self.kernels.values())

    def device_s(self, *kernels: str) -> float:
        """Device seconds of the hand kernels named (``HAND_KERNELS`` keys)."""
        pats = [re.compile(r"(?:^|[\s:])" + HAND_KERNELS[k] + r"\b") for k in kernels]
        return sum(ns for name, (_, ns) in self.kernels.items()
                   if any(p.search(name) for p in pats)) / 1e9

    def roofline(self, key: str, *kernels: str) -> float | None:
        """Least time of the recorded work over the kernels' device time, %."""
        dev = self.device_s(*kernels)
        if key not in self.work or dev <= 0:
            return None
        wide, nbytes = self.work[key]
        return 100.0 * W.least_s(wide, nbytes, self.card.wide_per_s)[0] / dev

    def breakdown(self) -> dict:
        ops = sorted(((name, ns / 1e9) for name, (_, ns) in self.kernels.items()),
                     key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


class Tracer:
    """Starts and stops everything of a traced window."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.spans = Spans()
        self.lines = StampedLines()
        self.wrappers = Wrappers()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self.wrappers.install()
        self.spans.on = True
        os.environ["CIRCUITS_PROVE_TRACE"] = "1"
        self._stderr, sys.stderr = sys.stderr, self.lines
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.mark_ns = time.perf_counter_ns()
        torch.ones(1, device=self.device)  # the first device event: aligns the clocks
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter_ns()
        try:
            self.prof.__exit__(None, None, None)
        finally:
            sys.stderr = self._stderr
            os.environ.pop("CIRCUITS_PROVE_TRACE", None)
            self.spans.on = False
            self.wrappers.remove()
        self.peak = torch.cuda.max_memory_allocated(self.device)

    def result(self, card: W.Card, counts: dict[str, int]) -> Trace:
        summary = profile_summary(self.prof.profiler.kineto_results.events())
        intervals = summary["intervals"]
        offset = min(a for a, _ in intervals) - self.mark_ns if intervals else 0
        lo, hi = self.t0 + offset, self.t1 + offset
        inside = [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]
        busy_ns, merged = busy_union(inside)
        phases: dict[str, float] = {}
        for _, line in self.lines.lines:
            m = PHASE_LINE.search(line)
            if m:
                phases[m[1]] = phases.get(m[1], 0.0) + float(m[2])
        trace = Trace((self.t1 - self.t0) / 1e9, busy_ns / 1e9, summary["kernels"], counts,
                      phases, dict(self.wrappers.work), self.peak, card)
        trace.gaps = self._gaps(merged, lo, hi, offset)
        return trace

    def _host_spans(self) -> list[tuple[int, int, str]]:
        """The loops' spans, and each prover phase from the mark before it
        (or the start of the call that holds it) to its own mark."""
        spans = list(self.spans.items)
        calls = sorted(s for s in spans if s[2] == "prove_batch")
        prev = None
        for t, line in self.lines.lines:
            m = PHASE_LINE.search(line)
            if not m:
                continue
            call = next((c for c in calls if c[0] <= t <= c[1]), None)
            start = prev if prev is not None and call and prev >= call[0] else (call[0] if call else t)
            spans.append((start, t, m[1]))
            prev = t
        return spans

    def _gaps(self, merged, lo: int, hi: int, offset: int) -> dict[str, float]:
        """Idle device time inside the window, by the innermost host span
        that holds each gap's middle."""
        spans = self._host_spans()
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        out: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2 - offset
            holding = [s for s in spans if s[0] <= mid <= s[1]]
            name = min(holding, key=lambda s: s[1] - s[0])[2] if holding else "harness"
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out
