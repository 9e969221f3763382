"""Spans and counts of the port's host work, kept in memory for a traced run.

Off by default. ``enable()`` starts recording, ``disable()`` stops it, and
``drain()`` hands over what was recorded and forgets it. While it is off,
``span()`` returns one shared object that does nothing, and a call site
guards ``count()`` with ``if tracing.on:``: each costs one check of the
module's flag, and nothing is allocated or recorded.

- A span (``Span``) records its name, its start and end on
  ``time.perf_counter_ns`` (the host clock to which the benchmark aligns
  the profiler's CUDA activity), the id of the span it opened inside, and
  the request it belongs to: the id of the ``call()`` that holds it (one
  ``prover.prove_users`` call) and, for one user's work, the user's index
  in that call, which the spans inside it inherit. No span synchronises the
  card. Where the host waits on the device, the wait is a span of its own
  (``readback``, ``h2d``), so waiting stays apart from working.
- A count records a name, a kernel or site key, and integers, summed over
  the calls: launches, the problem's size (elements, points, messages,
  rows), bytes copied each way.
- ``phase()`` is a prover phase's span. Given a device (the prover passes
  its domain's device under ``CIRCUITS_PROVE_TRACE=1``), it also
  synchronises that device at the phase's end and prints
  ``[prove] <phase>: <seconds>s`` to stderr, whether or not recording is on.

The spans nest on one stack: record from one thread at a time.
"""

from __future__ import annotations

import itertools
import math
import sys
import time

on = False

_spans: list[Span] = []
_counts: dict[tuple[str, str], dict[str, int]] = {}
_open: list[Span] = []
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
_call: int | None = None


class Span:
    """One recorded span; a context manager made only while recording."""

    __slots__ = ("id", "name", "start", "end", "parent", "call", "user")

    def __init__(self, name: str, user: int | None = None):
        parent = _open[-1] if _open else None
        self.id = next(_span_ids)
        self.name = name
        self.parent = parent.id if parent else None
        self.call = _call
        self.user = parent.user if user is None and parent else user
        self.start = self.end = 0

    def __enter__(self) -> Span:
        _open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        _open.remove(self)
        _spans.append(self)
        return False


class _Off:
    """What ``span()`` and ``call()`` return while recording is off."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, user: int | None = None):
    """A span named ``name`` (of user ``user`` of the current call, or its
    parent's user); the shared no-op while recording is off."""
    if not on:
        return _OFF
    return Span(name, user)


class _Call:
    def __enter__(self) -> int:
        global _call
        self.outer = _call
        _call = next(_call_ids)
        return _call

    def __exit__(self, *exc) -> bool:
        global _call
        _call = self.outer
        return False


def call():
    """A request: the spans opened inside carry a fresh call id."""
    if not on:
        return _OFF
    return _Call()


class _Phase:
    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self) -> None:
        self.span = Span(self.name).__enter__() if on else None
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        if exc[0] is None:
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
            seconds = (time.perf_counter_ns() - self.t0) / 1e9
            print(f"[prove] {self.name}: {seconds:.3f}s", file=sys.stderr, flush=True)
        if self.span is not None:
            self.span.__exit__(*exc)
        return False


def phase(name: str, device=None):
    """A prover phase's span; with ``device`` (a ``torch.device``) it also
    synchronises a CUDA device at its end and prints the phase's seconds."""
    if device is None:
        return span(name)
    return _Phase(name, device)


def count(name: str, key: str, **ints: int) -> None:
    """Add ``ints`` to the count ``(name, key)``; guard the call with
    ``if tracing.on:``."""
    if not on:
        return
    entry = _counts.setdefault((name, key), {})
    for field, value in ints.items():
        entry[field] = entry.get(field, 0) + value


def own_elements(x) -> int:
    """Elements of a (16, *batch) operand's batch axes, a broadcast axis
    (stride 0) once: what the operand itself holds."""
    return math.prod(s for s, st in zip(x.shape[1:], x.stride()[1:]) if st)


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def drain() -> tuple[list[Span], dict[tuple[str, str], dict[str, int]]]:
    """The spans closed and the counts made since the last drain (spans in
    the order they closed); both are forgotten here."""
    global _spans, _counts
    spans, counts = _spans, _counts
    _spans, _counts = [], {}
    return spans, counts
