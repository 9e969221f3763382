"""The port's criterion-equivalent benchmark suite, on the card.

    python -m circuits_halo2_tpu_torch.bench_suite [--device cpu]

The stages of the JAX package's ``bench_suite.py`` (at the repository's
root), under its metric names and units, with its data made from the same
seeds and its correctness gates, through the port's entry points. Each
metric is one JSON line on stdout. ``BENCH_STAGES`` picks the stages
(comma-separated; default ``build,keygen,prove,verify``; ``all`` runs every
one, in this order):

- ``build``: ``mst_build_2^{n}`` and ``mst_build_sorted_2^{n}``, the device
  tree (K1) of 2^``BENCH_TREE_LOG2`` (16) seeded leaves of two currencies;
  each root equals the native host sponge's.
- ``msm``: ``msm_pippenger_2^{n}x{B}`` for each n of ``BENCH_MSM_LOG2`` (13;
  a comma-separated list), ``BENCH_MSM_BATCH`` (4) rows of device-resident
  Montgomery scalars over one base set (K3), placed outside the timed
  window; row 0 equals the native host MSM (``gate_s``, its seconds).
- ``ntt``: ``ntt_2^{n}`` for each n of ``BENCH_NTT_LOG2`` (15), the time of
  one transform in a chain of ``BENCH_NTT_ITERS`` (8); a 256-point
  transform equals ``ntt_host``.
- ``keygen``, ``prove``, ``verify``: ``keygen_vk_pk_k11``,
  ``prove_mst_inclusion_k11`` and ``verify_mst_inclusion_k11``, user 0 of
  ``tests/fixtures_csv/entry_16.csv`` at k=11 on the hermez-raw-11 file
  (K1, K3); the Blake2b proof equals the JAX package's bytes
  (``tests/fixtures_torch_proofs.json``) and verifies. Any stage of the
  k=11 key makes ``keygen_vk_pk_k11``, as in the JAX suite.
- ``throughput``: ``prove_throughput_k11`` (proofs/min), ``BENCH_USERS`` (8)
  users proved and verified one at a time.
- ``batch_throughput``: ``prove_batch_throughput_k11`` (proofs/min), the
  same users in one ``prove_batch`` call; every proof verifies and equals
  the user's single proof.
- ``criterion``: the reference's criterion config (2^20 entries, 1
  currency, N_BYTES=8, k=13): ``criterion_build_2^20``,
  ``criterion_build_sorted_2^20``, ``criterion_keygen_k13``,
  ``criterion_prove_k13``, ``criterion_verify_k13``; the roots equal the
  host roots, the proof verifies.
- ``northstar``: 2^16 entries, 2 currencies, k=17: ``northstar_build_2^16``,
  ``northstar_srs_setup_k17``, ``northstar_keygen_k17``,
  ``northstar_prove_k17``, ``northstar_verify_k17``; the root equals the
  host root, the proof verifies.

Timing: a measured call runs once cold (``cold_s``), then ``BENCH_REPEATS``
(3) times warm; an ``s`` line's ``value`` is the warm median, ``min_s`` and
``max_s`` their spread. The k=17 prove runs one warm repeat, the SRS setup
only its one call. On the card every timed window ends in
``torch.cuda.synchronize()``. Every line names its device (``device``:
``torch.cuda.get_device_name``, or ``"cpu"``; ``device_count``;
``power_limit_w`` from ``nvidia-smi``, null on the CPU) and counts the K1
and K3 launches made since the previous line (``k1_launches``,
``k3_launches``; 0 on the CPU, where the plain versions run).

A prove line also has ``peak_mem_bytes`` (``max_memory_allocated`` over
the warm repeats) and, from two more proves outside the timed ones,
``phases_s`` and ``traced_s`` (the phases and the wall time of one prove
with ``CIRCUITS_PROVE_TRACE`` on, whose clock synchronises the card at each
phase) and, from one under ``torch.profiler``, ``device_busy_s``,
``idle_share`` (1 - busy over the warm median), ``launches`` (CUDA kernels)
``top_kernels`` and ``hand_kernels`` (each of the port's hand kernels with
its launches and device seconds); ``profiler`` says where that profile is
missing.

A failing stage prints its traceback, the other stages still run, and the
process exits 1. Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import native
from .ops import field as F
from .ops import field_torch as FT
from .ops import msm_kernel as MK
from .ops import poseidon_kernel as PK

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
PTAU_K11 = TESTS / "fixtures_ptau_hermez-raw-11"
ENTRY_CSV = TESTS / "fixtures_csv" / "entry_16.csv"
PROOF_FIXTURE = TESTS / "fixtures_torch_proofs.json"
K11 = (4, 2, 8, 11)  # LEVELS, N_CURRENCIES, N_BYTES, k of entry_16
CRITERION = (20, 1, 8, 13)
NORTHSTAR = (16, 2, 8, 17)
USER = "dxGaEAii"  # user 0 of the criterion and north-star trees
STAGES = ("build", "msm", "ntt", "keygen", "prove", "verify", "throughput",
          "batch_throughput", "criterion", "northstar")
K11_STAGES = ("keygen", "prove", "verify", "throughput", "batch_throughput")
DEFAULT_STAGES = "build,keygen,prove,verify"
TOP_KERNELS = 3
# The port's hand kernels, by the name of their CUDA function (csrc/*.cu)
HAND_KERNELS = (("K1", "poseidon_sponge_kernel"), ("K2", "poseidon_permute_kernel"),
                ("K3", "msm_scan_kernel"), ("K4", "poseidon_mxu_sponge_kernel"),
                ("K5/K6", "poseidon_mxu_probe_kernel"), ("X4", "ec_fft_stage_kernel"),
                ("X4 scale", "ec_fft_scale_kernel"), ("X0a", "mont_mul_kernel"),
                ("X0b", "linear_kernel"), ("X0c", "inv_kernel"), ("chain", "pow_kernel"),
                ("X1", "ntt_pass_kernel"))
PHASE_LINE = re.compile(r"\[prove\] (.+): ([0-9.]+)s$")


class GateError(RuntimeError):
    """A stage's result is wrong."""


def require(ok: bool, what: str) -> None:
    if not ok:
        raise GateError(what)


def resolve_device(name: str) -> torch.device:
    """The device to run on; a card that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} asked for, but torch.cuda.is_available() is False "
                           "(pass --device cpu for a run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def card_line(index: int = 0) -> str:
    """``nvidia-smi``'s name and power limit of card ``index``."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def identity(device: torch.device) -> dict:
    """The device fields of every line."""
    if device.type != "cuda":
        return {"device": "cpu", "device_count": 0, "power_limit_w": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    watts = card_line(index).rsplit(",", 1)[1].split()[0]
    return {"device": torch.cuda.get_device_name(index),
            "device_count": torch.cuda.device_count(), "power_limit_w": float(watts)}


def parse_list(spec: str) -> list[int]:
    return [int(x) for x in spec.split(",") if x.strip()]


def parse_stages(spec: str) -> list[str]:
    names = [s.strip() for s in spec.split(",") if s.strip()]
    if "all" in names:
        return list(STAGES)
    unknown = sorted(set(names) - set(STAGES))
    if unknown:
        raise ValueError(f"unknown stage(s) {unknown}; known: {', '.join(STAGES)}, all")
    return [s for s in STAGES if s in names]


@dataclass
class Timing:
    """One cold call and the warm ones after it, in seconds."""

    cold: float
    warm: list[float]

    @property
    def median(self) -> float:
        return statistics.median(self.warm) if self.warm else self.cold

    def fields(self) -> dict:
        warm = self.warm or [self.cold]
        return {"median_s": self.median, "min_s": min(warm), "max_s": max(warm),
                "cold_s": self.cold, "repeats": len(self.warm)}


class Bench:
    """The device, the repeat count, and the JSON lines emitted so far."""

    def __init__(self, device: torch.device, repeats: int):
        if repeats < 1:
            raise ValueError(f"BENCH_REPEATS must be at least 1, got {repeats}")
        self.device = device
        self.repeats = repeats
        self.identity = identity(device)
        self.lines: list[dict] = []
        self._seen = self._launches()

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @staticmethod
    def _launches() -> tuple[int, int]:
        return PK.hash_batch.launches, MK.segmented_scan.launches

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def clock(self, fn):
        """(fn(), seconds), the window ended by a synchronise on the card."""
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def warm(self, fn, repeats: int | None = None):
        """(the last result, [seconds]) of ``repeats`` calls (default the
        bench's)."""
        out, times = None, []
        for _ in range(self.repeats if repeats is None else repeats):
            out, seconds = self.clock(fn)
            times.append(seconds)
        return out, times

    def timed(self, fn, repeats: int | None = None):
        """(the last result, Timing) of one cold call and the warm ones."""
        _, cold = self.clock(fn)
        out, warm = self.warm(fn, repeats)
        return out, Timing(cold, warm)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int | None:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else None

    def emit(self, metric: str, value: float, unit: str, timing: Timing | None = None,
             **extra) -> dict:
        k1, k3 = self._launches()
        line = {"metric": metric, "value": value, "unit": unit, **self.identity}
        if timing is not None:
            line.update(timing.fields())
        line.update(extra)
        line.update(k1_launches=k1 - self._seen[0], k3_launches=k3 - self._seen[1])
        self._seen = (k1, k3)
        print(json.dumps(line), flush=True)
        self.lines.append(line)
        return line


# ---------------------------------------------------------------------------
# Where a prove's time goes
# ---------------------------------------------------------------------------

def traced(fn):
    """(fn(), {phase: seconds}) with ``CIRCUITS_PROVE_TRACE`` on; the trace
    lines still reach stderr."""
    buf = io.StringIO()
    before = os.environ.get("CIRCUITS_PROVE_TRACE")
    os.environ["CIRCUITS_PROVE_TRACE"] = "1"
    try:
        with contextlib.redirect_stderr(buf):
            out = fn()
    finally:
        if before is None:
            del os.environ["CIRCUITS_PROVE_TRACE"]
        else:
            os.environ["CIRCUITS_PROVE_TRACE"] = before
        sys.stderr.write(buf.getvalue())
    phases = {}
    for line in buf.getvalue().splitlines():
        m = PHASE_LINE.search(line)
        if m:
            phases[m[1]] = float(m[2])
    return out, phases


def profile_summary(events, wall_s: float) -> dict:
    """Device busy time, idle share over ``wall_s``, kernel count, the
    kernels with the most device time, and every hand kernel's launches and
    device seconds (``HAND_KERNELS``, 0 where it did not run), from the
    profiler's raw events (each with ``name()``, ``device_type()``,
    ``start_ns()`` and ``end_ns()``)."""
    from torch.autograd import DeviceType

    device = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if e.device_type() == DeviceType.CUDA]
    kernels = [d for d in device if not d[2].startswith(("Memcpy", "Memset"))]
    if not kernels:
        return {"profiler": "no device events"}
    busy_ns, end = 0, None
    for start, stop, _ in sorted(device):
        if end is None or stop > end:
            busy_ns += stop - (start if end is None else max(start, end))
            end = stop
    per_name: dict[str, list] = {}
    for start, stop, name in kernels:
        entry = per_name.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += stop - start
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    hand = []
    for key, fn in HAND_KERNELS:
        pattern = re.compile(r"(?:^|[\s:])" + fn + r"\b")
        hits = [entry for name, entry in per_name.items() if pattern.search(name)]
        hand.append({"kernel": key, "name": fn, "launches": sum(h[0] for h in hits),
                     "device_s": sum(h[1] for h in hits) / 1e9})
    busy = busy_ns / 1e9
    return {"profiler": "torch.profiler", "device_busy_s": busy, "idle_share": 1.0 - busy / wall_s,
            "launches": len(kernels),
            "top_kernels": [{"name": name[:160], "launches": count, "device_s": ns / 1e9}
                            for name, (count, ns) in top],
            "hand_kernels": hand}


def device_profile(bench: Bench, fn, wall_s: float) -> dict:
    """``profile_summary`` of one more call of ``fn`` under ``torch.profiler``
    (on the card only: the CPU has no device time to split). Only the device
    activity is recorded: the summary reads nothing else, and recording
    every host op too made a k=11 prove 6x slower (44 s for 7) and its
    summary 16 s on an H100 host. The raw events are read, not
    ``prof.events()``, whose Python objects take minutes to build for the
    half million launches of a prove."""
    if not bench.cuda:
        return {"profiler": "cpu run"}
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        bench.sync()
    t1 = time.perf_counter()
    summary = profile_summary(prof.profiler.kineto_results.events(), wall_s)
    print(f"bench_suite: profiled call {t1 - t0:.3f} s, summary {time.perf_counter() - t1:.3f} s",
          file=sys.stderr, flush=True)
    return summary


def measure_prove(bench: Bench, prove, repeats: int | None = None):
    """(proof, Timing, extra fields) of a prove: cold, then warm repeats
    (each proof equal to the cold one), then one traced phase by phase and
    one profiled, neither of them timed."""
    first, cold = bench.clock(prove)
    bench.reset_peak()
    warm = []
    for _ in range(bench.repeats if repeats is None else repeats):
        proof, seconds = bench.clock(prove)
        require(proof == first, "a warm prove made other bytes than the cold one")
        warm.append(seconds)
    timing = Timing(cold, warm)
    extra = {"peak_mem_bytes": bench.peak()}
    (proof, phases), traced_s = bench.clock(lambda: traced(prove))
    require(proof == first, "the traced prove made other bytes than the cold one")
    extra.update(phases_s=phases, traced_s=traced_s)
    extra.update(device_profile(bench, prove, timing.median))
    return first, timing, extra


# ---------------------------------------------------------------------------
# Host references
# ---------------------------------------------------------------------------

def host_tree_root(digests: np.ndarray, balances: np.ndarray):
    """Root of the tree of (digest, balances) leaves, any number of
    currencies, by the native host sponge."""
    p = F.FR_MOD
    users = [int.from_bytes(d.tobytes(), "big") % p for d in digests]
    sums = [[int(b) for b in balances[:, c]] for c in range(balances.shape[1])]
    hashes = native.poseidon_hash_batch(list(zip(users, *sums)), 1 + len(sums))
    while len(hashes) > 1:
        sums = [[s[i] + s[i + 1] for i in range(0, len(s), 2)] for s in sums]
        hashes = native.poseidon_hash_batch(
            [(*(s[i] % p for s in sums), hashes[2 * i], hashes[2 * i + 1])
             for i in range(len(hashes) // 2)], 2 + len(sums))
    return hashes[0], [s[0] % p for s in sums]


def seeded_leaves(n: int, ncur: int, balance_bits: int, entry=None):
    """The JAX benches' leaves: ``default_rng(0)`` digests and balances, leaf
    0 set to ``entry`` when given; and the generator, for what follows."""
    rng = np.random.default_rng(0)
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    if entry is not None:
        digests[0] = np.frombuffer(entry.hashed_username.to_bytes(32, "big"), dtype=np.uint8)
    balances = rng.integers(0, 1 << balance_bits, size=(n, ncur), dtype=np.uint64)
    if entry is not None:
        balances[0] = entry.balances
    return digests, balances, rng


def tree_stages(bench: Bench, names: tuple[str, str | None], digests, balances, rng):
    """The device build (and, when ``names[1]`` is given, the sorted build
    of ``rng``'s next usernames), each root gated on the host root. Returns
    the unsorted tree."""
    from .merkle.device_tree import build_device_tree, build_device_tree_sorted

    def build():
        tree = build_device_tree(digests, balances, bench.device)
        return tree, tree.root()

    (tree, root), timing = bench.timed(build)
    require(root == host_tree_root(digests, balances), f"{names[0]}: device root != host root")
    n = len(digests)
    bench.emit(names[0], timing.median, "s", timing, hashes_per_sec=(2 * n - 1) / timing.median)
    if names[1] is not None:
        usernames = rng.integers(0, 256, size=(n, 8), dtype=np.uint8).view("S8")[:, 0]

        def build_sorted():
            stree, order = build_device_tree_sorted(usernames, digests, balances, bench.device)
            return order, stree.root()

        (order, sroot), timing = bench.timed(build_sorted)
        ordered = usernames[order]
        require(bool((ordered[:-1] <= ordered[1:]).all()), f"{names[1]}: usernames not sorted")
        require(sroot == host_tree_root(digests[order], balances[order]),
                f"{names[1]}: device root != host root of the sorted leaves")
        bench.emit(names[1], timing.median, "s", timing)
    return tree


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def bench_build(bench: Bench, log2_leaves: int):
    """``mst_build_2^{n}`` and ``mst_build_sorted_2^{n}``; returns the root."""
    digests, balances, rng = seeded_leaves(1 << log2_leaves, 2, 48)
    tree = tree_stages(bench, (f"mst_build_2^{log2_leaves}", f"mst_build_sorted_2^{log2_leaves}"),
                       digests, balances, rng)
    return tree.root()


def bench_msm(bench: Bench, log2_points: int, nbatch: int):
    """``msm_pippenger_2^{n}x{B}``: device digits, Pippenger and the fetch of
    B results, bases precomputed and scalars placed beforehand."""
    from .ops import curve as C
    from .ops import msm as M

    n = 1 << log2_points
    rng = random.Random(7)
    # distinct small multiples are as good as random points for timing
    base = [C.g1_mul(C.G1_GEN, rng.randrange(1, F.FR_MOD)) for _ in range(64)]
    points = [base[i % 64] for i in range(n)]
    rows = [[rng.randrange(F.FR_MOD) for _ in range(n)] for _ in range(nbatch)]
    M.precompute_bases(points, bench.device)
    flat = [s for row in rows for s in row]
    scal_mont = torch.as_tensor(FT.to_mont_limbs(flat).reshape(FT.NLIMBS, nbatch, n),
                                device=bench.device)
    res, timing = bench.timed(lambda: M.msm_commit_dev(points, scal_mont))
    t0 = time.perf_counter()
    require(res[0] == native.g1_msm(points, rows[0]), "device MSM row 0 != host MSM")
    bench.emit(f"msm_pippenger_2^{log2_points}x{nbatch}", timing.median, "s", timing,
               points_per_sec=n * nbatch / timing.median, gate_s=time.perf_counter() - t0)


def bench_ntt(bench: Bench, log2_n: int, iters: int):
    """``ntt_2^{n}``: one transform's time in a chain of ``iters``."""
    from .ops import ntt as NTT

    n = 1 << log2_n
    rng = random.Random(11)
    omega = NTT.omega_for_k(log2_n)
    vals = [rng.randrange(F.FR_MOD) for _ in range(n)]
    a = torch.as_tensor(FT.to_mont_limbs(vals), device=bench.device)

    def chain():
        x = a
        for _ in range(iters):
            x = NTT.ntt(x, omega)
        return x

    _, cold = bench.clock(lambda: NTT.ntt(a, omega))
    _, chains = bench.warm(chain)
    timing = Timing(cold, [seconds / iters for seconds in chains])
    small = vals[:256]
    om_s = NTT.omega_for_k(8)
    got = FT.from_mont_ints(NTT.ntt(torch.as_tensor(FT.to_mont_limbs(small), device=bench.device),
                                    om_s))
    require(got == NTT.ntt_host(small, om_s), "device NTT != ntt_host at 256 points")
    bench.emit(f"ntt_2^{log2_n}", timing.median, "s", timing,
               butterflies_per_sec=(n // 2) * log2_n / timing.median, iters=iters)


@dataclass
class K11Run:
    """The k=11 key, the entry_16 tree, user 0's circuit, and the proofs
    made so far (user index -> Blake2b proof)."""

    art: object
    tree: object
    circuit: object
    instances: list
    proofs: dict


def k11_circuit(tree, user: int):
    from .models.mst_inclusion import MstInclusionCircuit

    return MstInclusionCircuit.init(*K11[:3], tree.generate_proof(user % 16))


def k11_setup(bench: Bench) -> K11Run:
    """``keygen_vk_pk_k11``: setup from the hermez-raw-11 file and keygen."""
    from .merkle.mst import MerkleSumTree
    from .utils import pipeline

    levels, ncur, nbytes, k = K11
    art, timing = bench.timed(lambda: pipeline.generate_setup_artifacts(
        k, str(PTAU_K11), levels, ncur, nbytes, bench.device))
    bench.emit("keygen_vk_pk_k11", timing.median, "s", timing)
    tree = MerkleSumTree.from_csv(str(ENTRY_CSV), bench.device)
    circuit = k11_circuit(tree, 0)
    return K11Run(art, tree, circuit, circuit.instances(), {})


def single_proof(run: K11Run, user: int, circuit=None) -> bytes:
    """User ``user``'s Blake2b proof, made once."""
    from .utils import pipeline

    if user not in run.proofs:
        circuit = circuit or k11_circuit(run.tree, user)
        run.proofs[user] = pipeline.full_prover(run.art, circuit, circuit.instances())
    return run.proofs[user]


def bench_prove_k11(bench: Bench, run: K11Run) -> None:
    """``prove_mst_inclusion_k11``: equal to the JAX package's Blake2b bytes."""
    from .utils import pipeline

    proof, timing, extra = measure_prove(
        bench, lambda: pipeline.full_prover(run.art, run.circuit, run.instances))
    fixture = json.loads(PROOF_FIXTURE.read_text())
    require(proof.hex() == fixture["blake2b_proof"],
            "k=11 Blake2b proof differs from tests/fixtures_torch_proofs.json")
    run.proofs[0] = proof
    bench.emit("prove_mst_inclusion_k11", timing.median, "s", timing, proof_bytes=len(proof),
               **extra)


def bench_verify_k11(bench: Bench, run: K11Run) -> None:
    from .utils import pipeline

    proof = single_proof(run, 0, run.circuit)
    ok, timing = bench.timed(lambda: pipeline.full_verifier(run.art, proof, run.instances))
    require(ok, "k=11 proof failed to verify")
    bench.emit("verify_mst_inclusion_k11", timing.median, "s", timing, ok=ok)


def bench_throughput(bench: Bench, run: K11Run, users: int) -> None:
    """``prove_throughput_k11``: each user's circuit, proof and verification
    in turn (the spread is over users)."""
    from .utils import pipeline

    _, cold = bench.clock(lambda: pipeline.full_prover(run.art, run.circuit, run.instances))
    times = []
    for u in range(users):
        def one():
            circuit = k11_circuit(run.tree, u)
            proof = pipeline.full_prover(run.art, circuit, circuit.instances())
            return proof, pipeline.full_verifier(run.art, proof, circuit.instances())

        (proof, ok), seconds = bench.clock(one)
        require(ok, f"user {u}'s proof failed to verify")
        run.proofs.setdefault(u % 16, proof)
        require(proof == run.proofs[u % 16], f"user {u}'s proof changed between calls")
        times.append(seconds)
    total = sum(times)
    bench.emit("prove_throughput_k11", users / (total / 60.0), "proofs/min", Timing(cold, times),
               users=users, total_s=total, incl_verify=True)


def bench_batch_throughput(bench: Bench, run: K11Run, users: int) -> None:
    """``prove_batch_throughput_k11``: ``users`` users' circuits built and
    proved in one ``prove_batch`` call (Blake2b, so ``full_verifier`` replays
    it), the rate over all warm calls; every proof verifies and equals the
    user's single proof."""
    from .models.prover import BlindingRng
    from .models.prover_batch import prove_batch
    from .utils import pipeline
    from .utils.transcript import Blake2bTranscript

    def batch():
        circuits = [k11_circuit(run.tree, u) for u in range(users)]
        proofs = prove_batch(run.art.params, run.art.pk, circuits, run.art.config,
                             [c.instances() for c in circuits],
                             rngs=[BlindingRng() for _ in circuits],
                             transcript_cls=Blake2bTranscript,
                             vk_digest=run.art.vk.transcript_repr, device=bench.device)
        return proofs, circuits

    _, cold = bench.clock(batch)
    bench.reset_peak()
    (proofs, circuits), warm = bench.warm(batch)
    peak = bench.peak()
    for u, (proof, circuit) in enumerate(zip(proofs, circuits)):
        require(pipeline.full_verifier(run.art, proof, circuit.instances()),
                f"batch proof of user {u} failed to verify")
        require(proof == single_proof(run, u % 16, circuit),
                f"batch proof of user {u} differs from its single proof")
    total = sum(warm)
    bench.emit("prove_batch_throughput_k11", users * len(warm) / (total / 60.0), "proofs/min",
               Timing(cold, warm), users=users, total_s=total, batched=True,
               peak_mem_bytes=peak)


def config_stages(bench: Bench, prefix: str, config: tuple, entry, balance_bits: int, *,
                  sorted_build: bool, time_srs: bool, prove_repeats: int | None) -> None:
    """Tree, keygen, prove and verify of one config (the criterion's or the
    north star's), under ``{prefix}_build_2^{levels}`` and so on; with
    ``time_srs`` also the unsafe SRS setup, which the JAX suite times where
    it writes the file."""
    from .models.mst_inclusion import MstInclusionCircuit
    from .utils import pipeline
    from .utils.srs import ParamsKZG, setup_cached, store_cached

    levels, ncur, nbytes, k = config
    digests, balances, rng = seeded_leaves(1 << levels, ncur, balance_bits, entry)
    tree = tree_stages(bench, (f"{prefix}_build_2^{levels}",
                               f"{prefix}_build_sorted_2^{levels}" if sorted_build else None),
                       digests, balances, rng)
    if time_srs:
        params, seconds = bench.clock(lambda: ParamsKZG.setup(k))
        store_cached(params)
        bench.emit(f"{prefix}_srs_setup_k{k}", seconds, "s", Timing(seconds, []))
    else:
        setup_cached(k)  # the SRS exists before keygen is timed, as in the JAX suite
    art, timing = bench.timed(lambda: pipeline.generate_setup_artifacts(
        k, None, levels, ncur, nbytes, bench.device))
    bench.emit(f"{prefix}_keygen_k{k}", timing.median, "s", timing)

    circuit = MstInclusionCircuit.init(levels, ncur, nbytes, tree.generate_proof(0, entry))
    instances = circuit.instances()
    proof, timing, extra = measure_prove(
        bench, lambda: pipeline.full_prover(art, circuit, instances), prove_repeats)
    require(pipeline.full_verifier(art, proof, instances), f"{prefix} proof failed to verify")
    bench.emit(f"{prefix}_prove_k{k}", timing.median, "s", timing, proof_bytes=len(proof), **extra)
    ok, timing = bench.timed(lambda: pipeline.full_verifier(art, proof, instances))
    require(ok, f"{prefix} proof failed to verify")
    bench.emit(f"{prefix}_verify_k{k}", timing.median, "s", timing, ok=ok)


def bench_criterion(bench: Bench) -> None:
    """The reference criterion config (``zk_prover/benches/
    full_solvency_flow.rs:13-16``): balances below 2^40, so the 2^20-leaf
    sums stay inside N_BYTES=8."""
    from .merkle.mst import Entry

    config_stages(bench, "criterion", CRITERION, Entry(USER, [11888]), 40, sorted_build=True,
                  time_srs=False, prove_repeats=None)


def bench_northstar(bench: Bench) -> None:
    """The north-star config: one warm prove at k=17."""
    from .merkle.mst import Entry

    config_stages(bench, "northstar", NORTHSTAR, Entry(USER, [11888, 41163]), 48,
                  sorted_build=False, time_srs=True, prove_repeats=1)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda:0", help="torch device (default cuda:0)")
    return p


def run(bench: Bench, stages: list[str], env=os.environ) -> list[str]:
    """Run ``stages`` with the sizes ``env`` gives; returns the failed ones."""
    failures: list[str] = []

    def stage(name, fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 - one stage's failure must not stop the others
            failures.append(name)
            print(f"bench_suite: stage {name} FAILED: {e!r}", file=sys.stderr, flush=True)
            traceback.print_exc()
            return None

    if "build" in stages:
        stage("build", bench_build, bench, int(env.get("BENCH_TREE_LOG2", 16)))
    if "msm" in stages:
        for log2 in parse_list(env.get("BENCH_MSM_LOG2", "13")):
            stage("msm", bench_msm, bench, log2, int(env.get("BENCH_MSM_BATCH", 4)))
    if "ntt" in stages:
        for log2 in parse_list(env.get("BENCH_NTT_LOG2", "15")):
            stage("ntt", bench_ntt, bench, log2, int(env.get("BENCH_NTT_ITERS", 8)))
    if any(s in stages for s in K11_STAGES):
        k11 = stage("setup", k11_setup, bench)
        users = int(env.get("BENCH_USERS", 8))
        if k11 is None:
            print("bench_suite: setup failed; skipping the k=11 stages", file=sys.stderr)
        else:
            for name, fn, args in (("prove", bench_prove_k11, ()), ("verify", bench_verify_k11, ()),
                                   ("throughput", bench_throughput, (users,)),
                                   ("batch_throughput", bench_batch_throughput, (users,))):
                if name in stages:
                    stage(name, fn, bench, k11, *args)
    if "criterion" in stages:
        stage("criterion", bench_criterion, bench)
    if "northstar" in stages:
        stage("northstar", bench_northstar, bench)
    return failures


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device)
    stages = parse_stages(os.environ.get("BENCH_STAGES", DEFAULT_STAGES))
    bench = Bench(device, int(os.environ.get("BENCH_REPEATS", 3)))
    failures = run(bench, stages)
    if failures:
        print(f"bench_suite: failed stages: {', '.join(failures)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
