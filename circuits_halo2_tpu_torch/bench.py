"""The port's headline benchmark: chained Poseidon hashing through K1.

    python -m circuits_halo2_tpu_torch.bench [--device cpu]

The witness-side hot loop of the JAX package's ``bench.py`` (at the
repository's root), under its metric name ``poseidon_bn254_hashes_per_sec``
(hashes/s): ``BENCH_BATCH`` lanes of the BN254 ConstantLength<3> sponge
(t=2, 8 full and 56 partial rounds) chained 262144 // batch times,
h <- H(h, h, h), each step one launch of ``ops/poseidon_kernel.hash_batch``.
The lanes start from the JAX bench's data: ``default_rng(0)`` draws 18
limbs below 2^14 a lane, the top one zeroed, read as 15-bit limbs of a
Montgomery residue with R = 2^255.

``BENCH_BATCH`` defaults to the lane count that one launch of the whole
trial needs, the fastest point of the sweep on the card; a comma-separated
list runs one line per batch (the sweep). A trial is 262,144 hashes at
every batch.
``BENCH_REPEATS`` (3) warm trials follow a cold one: ``value`` is the
batch times the iterations over the warm median (``trials_s`` lists them,
with ``min_s`` and ``max_s``; ``events_s`` the CUDA-event span of each
warm trial on the card). The final state of lane 0 must equal the same
chain of the host sponge (``ops/poseidon.hash_n``).

``vs_baseline`` divides by the native C++ sponge (``csrc/fieldcc.cpp``)
measured on this host's CPU just after, on all its threads
(``CIRCUITS_NATIVE_THREADS`` caps them), over 100,000 messages:
``baseline_host_hps``, ``baseline_host_threads``. The library is
required. ``vs_ref_64core_est`` divides by 2.0e6 hashes/s, the JAX bench's
assumed figure for the reference's rayon build on a 64-core host (no
published number; no measurement of any device).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from . import native
from .bench_suite import Bench, Timing, parse_list, parser, require, resolve_device
from .ops import field as F
from .ops import field_torch as FT
from .ops import poseidon as PS
from .ops import poseidon_kernel as PK

REF_64CORE_EST_HPS = 2.0e6  # an assumption carried from the JAX bench, not a measurement
HASHES_PER_TRIAL = 262144
DEFAULT_BATCH = HASHES_PER_TRIAL  # one launch a trial (the sweep's fastest point)
HOST_N = 100_000  # messages of the native baseline
LENGTH = 3  # a leaf preimage for 2 currencies
# the JAX bench's data: 15-bit limbs of a Montgomery residue of R = 2^255
LIMB15_BITS, NLIMBS15, LOW15 = 15, 18, 17
R15_INV = pow(1 << (LIMB15_BITS * LOW15), -1, F.FR_MOD)


def seeded_inputs(batch: int) -> list[list[int]]:
    """The JAX bench's (LENGTH, batch) inputs as canonical field elements."""
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 1 << 14, size=(LENGTH, NLIMBS15, batch), dtype=np.uint32)
    arr[:, LOW15:, :] = 0
    limbs = arr.astype(object)
    values = sum(limbs[:, i, :] << (LIMB15_BITS * i) for i in range(LOW15))
    return [[int(v) * R15_INV % F.FR_MOD for v in row] for row in values]


def chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` steps of h <- H(h, h, h) from the (LENGTH, 16, B) state x."""
    for _ in range(iters):
        h = PK.hash_batch(x)
        x = torch.stack([h] * LENGTH)
    return x


def host_chain(first: list[int], iters: int) -> int:
    """The same chain of one lane through the host sponge."""
    h = PS.hash_n(first)
    for _ in range(iters - 1):
        h = PS.hash_n([h] * LENGTH)
    return h


def native_baseline(n: int, trials: int) -> tuple[float, int]:
    """(hashes/s, threads) of the native host sponge over n random messages:
    the median of ``trials`` calls after a warm one."""
    rng = np.random.default_rng(1)
    words = rng.integers(0, 1 << 62, size=n * LENGTH, dtype=np.uint64)
    msgs = np.zeros((n * LENGTH, 32), dtype=np.uint8)
    msgs[:, :8] = words.view(np.uint8).reshape(-1, 8)
    native.poseidon_hash_bytes(msgs[: max(1, n // 10) * LENGTH], LENGTH)  # thread pool, pages
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        native.poseidon_hash_bytes(msgs, LENGTH)
        times.append(time.perf_counter() - t0)
    threads = int(os.environ.get("CIRCUITS_NATIVE_THREADS", os.cpu_count() or 1))
    return n / sorted(times)[len(times) // 2], threads


def bench_headline(bench: Bench, batch: int, iters: int) -> dict:
    """One ``poseidon_bn254_hashes_per_sec`` line at ``batch`` lanes x ``iters``."""
    inputs = seeded_inputs(batch)
    x = torch.as_tensor(FT.to_mont_limbs([v for row in inputs for v in row])
                        .reshape(FT.NLIMBS, LENGTH, batch).transpose(1, 0, 2).copy(),
                        device=bench.device)
    final, cold = bench.clock(lambda: chain(x, iters))
    want = host_chain([row[0] for row in inputs], iters)
    require(FT.from_mont_ints(final[0][:, :1])[0] == want,
            "device and host chained hashes differ in lane 0")
    warm, events = [], []
    for _ in range(bench.repeats):
        if bench.cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        _, seconds = bench.clock(lambda: chain(x, iters))
        warm.append(seconds)
        if bench.cuda:
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end) / 1e3)
    timing = Timing(cold, warm)
    hps = batch * iters / timing.median
    host_hps, host_threads = native_baseline(HOST_N, 3)
    return bench.emit("poseidon_bn254_hashes_per_sec", hps, "hashes/s", timing,
                      vs_baseline=hps / host_hps, trials_s=warm, events_s=events or None,
                      baseline_host_hps=host_hps, baseline_host_threads=host_threads,
                      vs_ref_64core_est=hps / REF_64CORE_EST_HPS, batch=batch, iters=iters)


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    bench = Bench(resolve_device(args.device), int(os.environ.get("BENCH_REPEATS", 3)))
    for batch in parse_list(os.environ.get("BENCH_BATCH", str(DEFAULT_BATCH))):
        bench_headline(bench, batch, max(1, HASHES_PER_TRIAL // batch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
