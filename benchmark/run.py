"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the mix names the loop module
(``loops/<entry>.py``) that sets the program up, runs one step of it, and
judges what the window made against ``benchmark/reference``.

A run: set-up (the loop's, which warms every shape the window uses),
``setup_s`` from the process's start to the window's; then steps, closed
loop, until the first one that ends at or after ``--seconds``: whole steps,
nothing cut; the program's state freed; the reference's judgement; the
import check. With ``--trace 0`` the metrics are the cell's end-to-end ones;
with ``--trace 1`` the window runs under ``trace.Tracer`` and the metrics
are the cell's per-layer ones, each read by ``metrics/<name>.py``.

The last line of standard output is the result, a JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a card (or with fewer than the cell asks for) the run prints no
result and exits 2; a forbidden module loaded in the process (``imports``)
exits 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

# what the program builds and caches stays in the checkout, at fixed paths
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``), or since
    this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def set_caches(root) -> None:
    base = root / "benchmark" / "_cache"
    for var, sub in CACHES.items():
        os.environ[var] = str(base / sub)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, fault=None,
            card=None) -> dict:
    """Set up, run the window, judge; the result's fields (``card`` and
    ``fault`` for the CPU tests and the control)."""
    import torch

    from . import faults, imports
    from . import trace as TR

    device = torch.device(device)
    cuda = device.type == "cuda"
    tracer = TR.Tracer(device) if trace else None
    spans = tracer.spans if tracer else TR.Spans()
    loop = spec.loop(cell.traffic).Loop(cell, seed, device, spans)
    loop.setup()
    if fault is not None:
        faults.FAULTS[fault](loop)
    setup_s = process_age_s()
    if cuda:
        torch.cuda.synchronize(device)
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    steps = 0
    while True:
        loop.step()
        steps += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    if tracer:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if tracer:
        peak = max(peak, tracer.peak)
    e2e = loop.end_to_end(elapsed)
    e2e["setup_s"] = setup_s
    print(f"window: {steps} steps in {elapsed:.3f} s, set-up {setup_s:.3f} s, {loop.counts()}",
          file=sys.stderr, flush=True)
    if card is None and cuda:
        from . import work

        card = work.card(device.index or 0)
    metrics, breakdown, dev = {}, None, {}
    if tracer:
        tr = tracer.result(card, loop.counts())
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = tr.breakdown()
        dev = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        print(f"trace: busy {tr.busy_s:.4f} of {tr.window_s:.4f} s, {tr.launches()} kernels, "
              f"work {tr.work}, phases {tr.phases}", file=sys.stderr, flush=True)
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    loop.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, attempted, failed = loop.judge()
    return {"correct": all(v <= limit for v, limit in checks.values()), "attempted": attempted,
            "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                       "count": cell.chips, "memory_peak_bytes": peak, **dev},
            **({"breakdown": breakdown} if breakdown else {}),
            "checks": {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()},
            "forbidden": imports.forbidden(), "card": card}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    set_caches(cell.root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    card = result.pop("card")
    bad = result.pop("forbidden")
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"card: {card.name}, {card.sms} SMs, max SM clock {card.max_sm_mhz} MHz, "
          f"power limit {card.power_limit_w} W", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
