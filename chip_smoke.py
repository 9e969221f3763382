"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``circuits_halo2_tpu_torch/csrc``,
checks each of the twelve (K1-K6, X4 the EC-FFT, X0a-X0c the field
arithmetic and the inversion, the power chain, X1 the NTT) against its
plain torch version on the
card (X4 at the path's 2^10 and 2^13 in two child processes, beside the
other checks; at 2^16, where the card is full, against setup(16)'s
analytic Lagrange bases; X0 and X1 at the prover's shapes, their plain
versions run inside ``field_torch.plain()``), then drives seven paths
through their user entry points, each with the launch counts set to 0
just before it and read just after:

- the proving path (K1, K3, X4, X0a-X0c and X1; the power chain is off
  every path since the inversion has its own kernel, and launches 0):
  - the reference criterion config (a 2^20-entry Merkle sum tree,
    N_CURRENCIES=1, N_BYTES=8, LEVELS=20, k=13): the tree, its sorted
    build, keygen, a proof that verifies, and the proofs of the JAX
    package's seeded synthetic witness, equal to its bytes under both
    transcripts (tests/fixtures_torch_criterion.json);
  - the entry_16 k=11 fixture, whose proofs must equal the JAX package's
    byte for byte (tests/fixtures_torch_proofs.json);
  - SRS files larger than 2^k downsized through X4: the hermez-raw-11
    ceremony file to k=10 (its Lagrange bases hash to the JAX package's)
    and the north-star SRS from 2^17 to 2^13 (three identities, then a
    criterion proof that verifies);
  - the north-star config (2^16 entries, 2 currencies, N_BYTES=8,
    LEVELS=16, k=17): tree, keygen, a proof that verifies, and, where the
    fixture has them, the JAX package's north-star proofs byte for byte;
- the batch prover (K3, X0, X1) on the criterion key: one prove traced phase by
  phase, users 0-3 proved one at a time, then users 0-7 by
  ``prove_batch`` at U=4 and U=8 (each batch proof equal byte for byte to
  the single proof, or to the other batch size's), and users 0-1 with
  Blake2b at U=2 (user 0 equal to the criterion proof); proofs per minute
  and peak memory;
- the operator's round at the criterion width (K1, K3, X0, X1): a 2^20-entry
  ``MerkleSumTree.from_entries`` (root equal to ``build_device_tree``'s),
  ``Round`` on a k=13 SRS file, the ownership proofs, the commitment, two
  users' inclusion proofs with the user-side checks, and the verifier
  generated from the VK accepting both in the Yul VM;
- the incremental inclusion chain (K1, K3, X0, X1): at the reference example's
  size (entry_16 rounds 1-3) the step chain at k=11 and the chained SNARK
  at k=13 equal to the JAX package's bytes
  (tests/fixtures_torch_incremental.json); at the criterion width three
  seeded 2^20-entry round CSVs, ``prove_chain`` of user 777,777 (three
  ``from_entries`` trees, three k=13 step proofs), both chain verifiers
  with a flipped byte and a broken chaining rejected, and the final states
  recomputed on the host; then the JAX package's synthetic criterion
  rounds: three k=13 step proofs and the k=14 chained SNARK byte for byte;
- the recursion example (``examples/nova_incremental_verifier``: the
  circom-parity chain, the k=11 step chain on the card, NIFS folding and
  Spartan compression) in a child process started after the kernel build;
- the rank mesh (``parallel/*``; K1, K3, X0, X1), each rank a child process of
  ``parallel/worker.launch``: a 4-rank gloo world on the one card (asked
  for explicitly; its collectives staged through host memory, since NCCL
  refuses two ranks on one GPU) whose every rank hashes and reduces the
  criterion's 2^20 leaves over the mesh (root equal to the host root),
  runs keygen at k=13 under the mesh (VK equal to the single-device VK)
  and proves the JAX package's synthetic criterion witness with the
  Keccak transcript (bytes equal to the fixture, verified, a flipped byte
  rejected); then a 1-rank NCCL world whose sharded NTT (2^15, batch 4)
  and commitment (2^13 lanes) equal the single-device results. The
  ranks' launches count toward the path's;
- the port's bench entry points (K1, K3), each a child process:
  ``python -m circuits_halo2_tpu_torch.bench_suite`` at its quick stages
  (the 2^16 tree, MSM 2^13 x 4, NTT 2^15, keygen, prove and verify at
  k=11 with one warm repeat; the k=11 proof equal to the JAX package's
  bytes, the prove profiled), started beside the incremental path and
  joined here, and the headline ``python -m circuits_halo2_tpu_torch.bench``
  alone; their lines' launches count toward the path's;
- the Poseidon engine at the criterion width: the 2^20 tree's root
  through the tensor-core sponge (K4) from raw digests and sums, equal to
  the host root; the bare permutation (K2) of the leaf states; and the
  probe experiment (K5, with the K6 exactness check).

Prints one line per phase with its wall time, each path's launch counts,
the kernels' JSON summary (times, launches summed over the paths, bounds),
the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and no ``ok`` line is printed. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TESTS = ROOT / "tests"
SEED = 0
CRITERION = (20, 1, 8, 13)  # LEVELS, N_CURRENCIES, N_BYTES, k (BASELINE.md:10)
NORTHSTAR = (16, 2, 8, 17)  # the same for the north-star config (bench_suite.py:267-338)
USER = "dxGaEAii"
BATCH_USERS = 8  # users 0-7 of the criterion tree go through the batch prover
SINGLE_USERS = 4  # users 0-3 of them are also proved one at a time
BATCH_SIZES = (4, 8)  # users per prove_batch call
ROUND_USERS = (0, 777_777)  # the two users of the operator's round
CRITERION_FIXTURE = TESTS / "fixtures_torch_criterion.json"
INCREMENTAL_FIXTURE = TESTS / "fixtures_torch_incremental.json"
CHAIN_ROUNDS = 3  # rounds of the criterion-width incremental chain
CHAIN_USER = 777_777  # the user proved across them
PARALLEL_RANKS = 4  # gloo ranks of the parallel path, all on the one card
ROUND_BALANCE_CAP = 1 << 40  # per entry: a 2^20-leaf sum stays below 2^60
EXAMPLE = "circuits_halo2_tpu_torch.examples.nova_incremental_verifier"
G1_GEN = (1, 2)  # the BN254 G1 generator, affine

# Peak rates of one H100 SXM at 700 W, for the bounds. Tensor cores and
# memory: NVIDIA's data sheet. The 32 x 32 -> 64 integer multiply has no
# published rate: assumed 64 IMAD results per clock per SM (the CUDA
# programming guide's table for compute capability 9.0) at the 1.98 GHz
# boost clock, two IMADs per wide multiply (low and high halves).
WIDE_MUL_PER_S = 132 * 64 * 1.98e9 / 2
INT8_OPS_PER_S = 1979e12
BYTES_PER_S = 3.35e12
# Wide multiplies of the fewest-multiply field operations the port has
# (csrc/bn254_fast.cuh): a Montgomery reduction 68 (64 word products and 8
# quotient words, each a low half only), so a product 132 (64 + 68), a
# squaring 104 (36 + 68), and a two-product MDS row s0·m0 + s1·m1 with one
# reduction 196 (128 + 68).
MUL, SQR, MUL2 = 132, 104, 196
PERM_WIDE = 72 * (2 * SQR + MUL) + 128 * MUL2  # a permutation: 72 x^5, 64 rounds x 2 MDS rows
MADD_WIDE = 7 * MUL + 4 * SQR  # a mixed add (madd-2007-bl): 7 products, 4 squarings
FE = 32  # bytes of one field element as the kernels read and write it (8 u32 words)
# K3 per point: the px and py limbs, the digit and the flag in, three limb outputs
K3_BYTES = 2 * 16 * 8 + 8 + 1 + 3 * 16 * 8
# X4: a Jacobian doubling (dbl-2009-l) 2 products and 5 squarings, a complete
# addition (add-2007-bl) 11 products and 5 squarings; a point 96 bytes (three
# 32-byte coordinates), a plain scalar 32
DBL_WIDE = 2 * MUL + 5 * SQR
ADD_WIDE = 11 * MUL + 5 * SQR
X4_BIG = 16  # X4's exact check at full width: g_to_lagrange of setup(16)'s bases
# X0 and X1 read and write the port's int64 limbs: 128 bytes an element
LIMB_FE = 16 * 8
# Profiles taken before giving up on one that misses kernels (seen after
# a few in one process)
PROFILE_TRIES = 8


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Context manager printing one line per phase with its wall time."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        torch.cuda.synchronize()
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"[phase] {self.name}: {status} in {time.perf_counter() - self.t0:.3f} s")
        return False


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of card 0."""
    from circuits_halo2_tpu_torch.bench_suite import card_line as line

    return line(0)


def cuda_ms(fn, iters: int, warm: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> int:
    return max(int((x - y).abs().max()) for x, y in zip(a, b))


def bound_ms(wide_muls=0.0, tensor_ops=0.0, nbytes=0.0) -> tuple[float, str]:
    """The least time the card could take: the slower of its multiply units
    (CUDA-core wide multiplies and int8 tensor cores run side by side) and
    its memory, in ms, and which of operations or bytes that is."""
    ops_s = max(wide_muls / WIDE_MUL_PER_S, tensor_ops / INT8_OPS_PER_S)
    mem_s = nbytes / BYTES_PER_S
    return max(ops_s, mem_s) * 1e3, "operations" if ops_s >= mem_s else "bytes"


def k3_work(pvalid, seg, L: int) -> tuple[int, int]:
    """K3's work on this data: wide multiplies, one mixed add for each valid
    point that continues a segment inside its chunk (a segment's first point
    only starts the sum), and bytes, every input and output once."""
    s, v = seg.reshape(-1, L), pvalid.reshape(-1, L)
    adds = int((v[:, 1:] & (s[:, 1:] == s[:, :-1])).sum())
    return adds * MADD_WIDE, s.numel() * K3_BYTES


def k3_bound(pvalid, seg, L: int) -> tuple[float, str]:
    wide, nbytes = k3_work(pvalid, seg, L)
    return bound_ms(wide, 0, nbytes)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def random_mod(rng: np.random.Generator, count: int, mod: int) -> list[int]:
    raw = rng.integers(0, 256, size=(count, 32), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % mod for r in raw]


def random_fr(rng: np.random.Generator, count: int) -> list[int]:
    from circuits_halo2_tpu_torch.ops.field_torch import FR

    return random_mod(rng, count, FR.mod_int)


def sorted_scan_inputs(xs, ys, valid, scal_mont):
    """What the Pippenger hands K3: points gathered in digit order."""
    from circuits_halo2_tpu_torch.ops import msm as M

    digits = M.digits_from_mont(scal_mont)
    perm = torch.argsort(digits, dim=-1, stable=True)
    seg = torch.gather(digits, -1, perm)
    pxy = torch.cat([xs, ys], dim=0)[:, perm]
    return pxy[:16], pxy[16:], valid[perm], seg, M._seg_chunk_len(xs.shape[1])


def check_k1(device, rng, report):
    from circuits_halo2_tpu_torch import native
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK

    n = 1 << 16
    for length in (2, 3, 4):
        cols = [random_fr(rng, n) for _ in range(length)]
        for c in cols:
            c[0], c[1] = 0, FT.FR.mod_int - 1
        inp = torch.stack([torch.as_tensor(FT.to_mont_limbs(c), device=device) for c in cols])
        got = PK.hash_batch(inp)
        want = PK.hash_batch_ref(inp)
        err = max_abs_err([got], [want])
        if err or not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at L={length}")
        host = native.poseidon_hash_batch([[c[i] for c in cols] for i in range(64)], length)
        if FT.from_mont_ints(got[:, :64]) != host:
            raise AssertionError(f"K1 differs from the host sponge at L={length}")
        report["k1_err"] = max(report.get("k1_err", 0), err)
        log(f"K1 L={length} n={n}: equal to plain torch and (first 64) to host hash_n")


def check_k3(device, rng, report):
    """K3 against its plain version on what the Pippenger hands it: random
    scalars with 0, p - 1 and P + (-P) at 2^11 and 2^13 (4 columns), a
    keygen batch of 16 columns at 2^13, skewed digits (90 % zero scalars, 3
    columns: bucket 0 spans whole chunks) at 2^13 and at 2^14, whose chunks
    are twice as long, and 3 columns at the north star's 2^17, whose chunks
    have the longest length, 512."""
    from circuits_halo2_tpu_torch import native
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK

    bases = {}
    for logn, batch, zeros in ((11, 4, 0.0), (13, 4, 0.0), (13, 16, 0.0), (13, 3, 0.9),
                                (14, 3, 0.9), (17, 3, 0.0)):
        n = 1 << logn
        if logn not in bases:
            points = native.g1_fixed_base_muls(G1_GEN, random_fr(rng, n))
            points[3] = None
            points[9] = (points[8][0], FT.FQ.mod_int - points[8][1])  # -P
            bases[logn] = points
        points = bases[logn]
        rows = [random_fr(rng, n) for _ in range(batch)]
        for r in rows:
            for i in np.flatnonzero(rng.random(n) < zeros):
                r[i] = 0
        rows[0][0], rows[0][1] = 0, FT.FR.mod_int - 1
        rows[0][8] = rows[0][9]  # P + (-P) in one bucket
        scal = torch.as_tensor(
            FT.to_mont_limbs([v for r in rows for v in r]).reshape(16, batch, n), device=device)
        xs, ys, valid = M.precompute_bases(points, device)
        px, py, pv, seg, L = sorted_scan_inputs(xs, ys, valid, scal)
        got = MK.segmented_scan(px, py, pv, seg, L)
        want = MK.segmented_scan_ref(px, py, pv, seg, L)
        err = max_abs_err(got, want)
        what = f"n=2^{logn} batch={batch} zero scalars {zeros:.0%}"
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K3 differs from its plain version at {what}")
        report["k3_err"] = max(report.get("k3_err", 0), err)
        log(f"K3 {what} L={L}: limb-exact against plain torch")
        if logn == 13 and batch != 16:
            commits = M.msm_commit_dev(points, scal)
            host = [native.g1_msm(points, r) for r in rows]
            if commits != host:
                raise AssertionError(f"msm_commit_dev differs from native g1_msm at {what}")
            log(f"msm_commit_dev at {what} (0, p-1, P+(-P), None base) == native g1_msm")


def check_k2(device, rng, report):
    """K2 at 2^20 states (0 and p - 1 in both words) against its plain
    version, and permute(x, cap(1))[0] against K1 at L = 1."""
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK

    n = 1 << 20
    s0, s1 = random_fr(rng, n), random_fr(rng, n)
    s0[0], s1[0], s0[1], s1[1] = 0, 0, FT.FR.mod_int - 1, FT.FR.mod_int - 1
    a = torch.as_tensor(FT.to_mont_limbs(s0), device=device)
    b = torch.as_tensor(FT.to_mont_limbs(s1), device=device)
    got, want = PK.permute(a, b), PK.permute_ref(a, b)
    err = max_abs_err(got, want)
    require(err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)),
            "K2 differs from its plain version at 2^20")
    cap = torch.as_tensor(FT.to_mont_limbs([1 << 64]), device=device).expand(16, n).contiguous()
    require(torch.equal(PK.permute(a, cap)[0], PK.hash_batch(a[None])),
            "permute(x, cap(1))[0] differs from K1 at L=1")
    report["k2_err"] = err
    log(f"K2 n=2^20: equal to plain torch; permute(x, cap(1))[0] == K1 L=1")


def check_k4(device, rng, report):
    """K4 at 2^16 messages (0, p - 1 and 2^256 - 1 in every word) against its
    plain version and against K1 on the same messages."""
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM

    n = 1 << 16
    for length in (2, 3, 4):
        raw = torch.as_tensor(rng.integers(0, 1 << 16, size=(length, 16, n), dtype=np.int64),
                              device=device)
        raw[:, :, 0] = 0
        raw[:, :, 1] = torch.as_tensor(FT.int_to_limbs(FT.FR.mod_int - 1), device=device)
        raw[:, :, 2] = 0xFFFF
        got, want = PM.hash_batch_mxu(raw), PM.hash_batch_mxu_ref(raw)
        err = max_abs_err([got], [want])
        require(err == 0 and torch.equal(got, want), f"K4 differs from its plain version at L={length}")
        k1 = FT.from_mont(PK.hash_batch(FT.to_mont(raw.movedim(1, 0)).movedim(0, 1)))
        require(torch.equal(got, k1), f"K4 differs from K1 at L={length}")
        report["k4_err"] = max(report.get("k4_err", 0), err)
        log(f"K4 L={length} n={n}: equal to plain torch and to K1 (canonical)")


def check_k5_k6(device, report):
    """The probe kernel at the experiment's shape (2^16 lanes, 64 iterations)
    for each variant, and K6's one reduced multiply, against plain torch."""
    from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP

    for variant in EXP.VARIANTS:
        x, y = EXP.make_inputs(variant, EXP.LANES, 1, device)
        got, want = EXP.run(variant, x, y, EXP.ITERS_LO), EXP.run_ref(variant, x, y, EXP.ITERS_LO)
        err = max_abs_err([got], [want])
        require(err == 0 and torch.equal(got, want), f"K5 {variant} differs from its plain version")
        report["k5_err"] = max(report.get("k5_err", 0), err)
    log(f"K5 {', '.join(EXP.VARIANTS)} at {EXP.LANES} lanes x {EXP.ITERS_LO} iterations: "
        "equal to plain torch")
    x, y = EXP.make_inputs("mxu_mul", 8 * 128, 2, device)
    got, want = EXP.mxu_mul_once(x, y), EXP.PM.mul_ref(x, y)
    report["k6_err"] = max_abs_err([got], [want])
    require(report["k6_err"] == 0, "K6 differs from its plain version")
    log("K6 one reduced multiply at 8 x 128 lanes: equal to plain torch")


def check_x4(device, rng, report):
    """X4 against its plain version, limb for limb: at n = 16 with an
    infinity lane, the forward transform and the n^-1-scaled inverse as one
    batch of two, both rows also against the host ``ec_fft``, and the user
    entry ``ec_fft_device`` (forward, scaled inverse) against the host too.
    The main path's shapes are ``x4_ceremony``'s and ``x4_full_width``'s,
    each checked in a child process."""
    from circuits_halo2_tpu_torch import native
    from circuits_halo2_tpu_torch.ops import curve as C
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field as F
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.utils import ec_fft as EC

    n = 16
    points = native.g1_fixed_base_muls(G1_GEN, random_fr(rng, n))
    points[7] = None
    omega = NTT.omega_for_k(4)
    omega_inv, n_inv = F.fr_inv(omega), F.fr_inv(n)
    args = EC.transform_inputs(points, [(omega, 1), (omega_inv, n_inv)], device)
    got, want = EK.ec_fft(*args), EK.ec_fft_ref(*args)
    err = max_abs_err(got, want)
    require(err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)),
            "X4 differs from its plain version at n=16")
    host_fwd = EC.ec_fft(points, omega)
    host_inv = [None if p is None else C.g1_mul(p, n_inv) for p in EC.ec_fft(points, omega_inv)]
    require(EC.jacobian_to_affine(*got) == [host_fwd, host_inv], "X4 differs from the host ec_fft")
    require(EC.ec_fft_device(points, omega, 1, device) == host_fwd
            and EC.ec_fft_device(points, omega_inv, n_inv, device) == host_inv,
            "ec_fft_device differs from the host ec_fft")
    log("X4 n=16 (forward and scaled inverse, infinity lane): equal to plain torch and to "
        "the host ec_fft")
    report["x4_err"] = err


def mont_limbs(device, rng, shape, spec=None) -> torch.Tensor:
    """(16, *shape) canonical Montgomery limbs of random elements, 0 and p - 1
    first and last."""
    from circuits_halo2_tpu_torch.ops import field_torch as FT

    spec = spec or FT.FR
    vals = random_mod(rng, int(np.prod(shape)), spec.mod_int)
    vals[0], vals[-1] = 0, spec.mod_int - 1
    return torch.as_tensor(FT.to_mont_limbs(vals, spec), device=device).reshape((16,) + shape)


# The Domain's transforms, each one X1 call with its factors folded in
DOMAIN_METHODS = ("coeff_to_extended", "lagrange_to_coeff", "extended_to_coeff",
                  "vanishing_to_coeff")
# The rows of the entry_16 k=11 round's 2^11 transforms (keygen's and the
# prove's Lagrange-to-coefficient calls: 9, 19 and 20 columns a call)
K11_ROWS = (9, 19, 20)


def check_x0_x1(device, report):
    """X0a-X0c, the power chain and X1 against their plain versions on the
    card, limb for limb, at the path's shapes: X0a on k=13 columns (16, 1, 8,
    2^13) x a (16, 1, 1, 2^13) lane table, on a strided column view x a
    challenge, on raw limbs (to_mont), at k=17's extended width 2^19, and on
    Fq at an MSM's (16, 3, 2^13); X0b's three op codes on the k=13 operands;
    X0c (the divstep inversion) on batch_inv_dev's (16, 1, 3, 1), on 2^16
    elements with zeros and on raw limbs, Fr and Fq; the chain (mont_pow)
    at p - 2 and 5; X1 through ntt and intt at 2^13 x 4, 2^16 x 8, 2^17,
    2^19 x 2 and 2^11 at the k=11 prove's batches (one pass, a row over a
    cluster of blocks; each plan logged), on a transposed view (as
    parallel/ntt_sharded hands one over), and the Domain's four transforms
    with their factors folded in (k=13, n_ext = 2^16: coeff_to_extended,
    lagrange_to_coeff, extended_to_coeff, vanishing_to_coeff; and k=11's
    lagrange_to_coeff) against the plain sequence of the parent (pad, X0a,
    the transform, X0a). The plain versions run inside ``FT.plain()``."""
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.utils import poly_device as PD

    rng = np.random.default_rng(SEED + 12)

    def same(key, fn, what, plain_fn=None):
        got = fn()
        with FT.plain():
            want = (plain_fn or fn)()
        err = max_abs_err([got], [want])
        require(err == 0 and torch.equal(got, want), f"{key.upper()} differs from its plain "
                f"version at {what}")
        report[f"{key}_err"] = max(report.get(f"{key}_err", 0), err)

    n13 = 1 << 13
    cols, lanes = mont_limbs(device, rng, (1, 8, n13)), mont_limbs(device, rng, (1, 1, n13))
    same("x0a", lambda: FT.mont_mul(cols, lanes), "k=13 columns x a lane table")
    wide, chal = mont_limbs(device, rng, (1, 12, n13)), mont_limbs(device, rng, (1, 1, 1))
    same("x0a", lambda: FT.mont_mul(wide[:, :, 2::3], chal), "a strided column view x a challenge")
    raw = torch.as_tensor(rng.integers(0, 1 << 16, (16, 3, n13)), device=device)
    same("x0a", lambda: FT.to_mont(raw), "to_mont of raw limbs (values up to 2^256 - 1)")
    ext = mont_limbs(device, rng, (1, 2, 1 << 19))
    same("x0a", lambda: FT.mont_mul(ext, ext[:, :, :1]), "k=17's extended width 2^19")
    fq = [mont_limbs(device, rng, (3, n13), FT.FQ) for _ in range(2)]
    same("x0a", lambda: FT.mont_mul(*fq, FT.FQ), "Fq (16, 3, 2^13)")
    same("x0b", lambda: FT.add_mod(cols, lanes), "add, k=13 columns x a lane table")
    same("x0b", lambda: FT.sub_mod(cols, lanes), "sub, k=13 columns x a lane table")
    same("x0b", lambda: FT.neg_mod(cols), "neg, k=13 columns (0 among them)")
    same("x0b", lambda: FT.sub_mod(fq[0], fq[1], FT.FQ), "sub, Fq")
    for spec in (FT.FR, FT.FQ):
        for shape in ((1, 3, 1), (1 << 16,)):
            z = mont_limbs(device, rng, shape, spec)
            same("x0c", lambda: FT.inv_mont(z, spec), f"inv_mont {spec} {shape} (0 among them)")
        same("x0c", lambda: FT.inv_mont(raw, spec), f"inv_mont {spec} of raw limbs")
    for e in (FT.FR.mod_int - 2, 5):
        same("x0c_pow", lambda: FT.mont_pow(cols[:, :, :2], e), f"mont_pow, exponent {e}")
    for k, shape in ((13, (1, 4, n13)), (16, (1, 8, 1 << 16)), (17, (1, 1, 1 << 17)),
                     (19, (1, 2, 1 << 19))):
        a, omega = mont_limbs(device, rng, shape), NTT.omega_for_k(k)
        same("x1", lambda: NTT.ntt(a, omega), f"ntt 2^{k} x {shape[1]}")
        same("x1", lambda: NTT.intt(a, omega), f"intt 2^{k} x {shape[1]}")
    n11, plans = 1 << 11, []
    for rows in K11_ROWS:  # the one pass, a row over a cluster of blocks
        a, omega = mont_limbs(device, rng, (1, rows, n11)), NTT.omega_for_k(11)
        plans.append(f"{rows} rows: " + "; ".join(
            f"{p['kind']}, {p['blocks']} blocks of {p['threads']} threads, {p['lines']} rows "
            f"a block, clusters of {p['cluster']}" for p in NTT.plan(n11, rows)))
        same("x1", lambda: NTT.ntt(a, omega), f"ntt 2^11 x {rows}")
        same("x1", lambda: NTT.intt(a, omega), f"intt 2^11 x {rows}")
    log("X1's plan at 2^11 for the k=11 prove's batches: " + " | ".join(plans))
    view = mont_limbs(device, rng, (2, 1 << 7, 1 << 6)).transpose(2, 3)
    same("x1", lambda: NTT._ntt_device(view, NTT.omega_for_k(7)), "a transposed (2, 2^6, 2^7) view")
    for k, rows, methods in ((CRITERION[3], 3, DOMAIN_METHODS),
                             (11, max(K11_ROWS), ("lagrange_to_coeff",))):
        dom = PD.domain(k, 5, str(device))
        for method in methods:
            width = dom.n if method in ("coeff_to_extended", "lagrange_to_coeff") else dom.n_ext
            a = mont_limbs(device, rng, (1, rows, width))
            same("x1", lambda: getattr(dom, method)(a),
                 f"k={k} Domain.{method} (16, 1, {rows}, {width})",
                 lambda: unfused_transform(dom, method, a))
    log("X0a (Fr: lane table, strided view, raw limbs, 2^19; Fq), X0b (add, sub, neg), X0c "
        "((16, 1, 3, 1), 2^16 and raw limbs; Fr and Fq), the chain (p - 2, 5) and X1 (ntt, intt "
        f"at 2^13 x 4, 2^16 x 8, 2^17, 2^19 x 2 and 2^11 x {', '.join(map(str, K11_ROWS))}; a "
        "transposed view; the Domain's four fused transforms at k=13 and lagrange_to_coeff at "
        "k=11 against the parent's plain sequence): equal to plain torch")


def unfused_transform(dom, method: str, a: torch.Tensor) -> torch.Tensor:
    """A Domain transform as the parent ran it: the zero padding and each
    factor a product of its own around the plain transform."""
    from circuits_halo2_tpu_torch.ops import field as F
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import ntt as NTT

    def lanes(t):
        return t.reshape((16,) + (1,) * (a.dim() - 2) + (-1,))

    def inverse(x, omega):
        n_inv = FT.const_tensor(FT.FR.const(F.fr_inv(int(x.shape[-1]))), x.device, x.dim())
        return FT.mont_mul(NTT.ntt_ref(x, F.fr_inv(omega)), n_inv)

    if method == "coeff_to_extended":
        padded = torch.nn.functional.pad(a, (0, dom.n_ext - int(a.shape[-1])))
        return NTT.ntt_ref(FT.mont_mul(padded, lanes(dom._coset)), dom.omega_ext)
    if method == "lagrange_to_coeff":
        return inverse(a, dom.omega)
    if method == "vanishing_to_coeff":
        a = FT.mont_mul(a, lanes(dom._zh_inv))
    return FT.mont_mul(inverse(a, dom.omega_ext), lanes(dom._coset_inv))


def device_ms(fn, iters: int, names: tuple) -> tuple[float, float]:
    """(device ms a call, launches a call) of the kernels whose name holds one
    of ``names``: ``torch.profiler``'s CUDA kernel durations over ``iters``
    calls after a warm one (device time only, whatever the host adds). A
    profile that recorded none of them, or a count that is no multiple of
    ``iters`` (both seen in a process that had profiled before), is taken
    again, up to ``PROFILE_TRIES`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and any(k in e.name() for k in names)]
        if spans and len(spans) % iters == 0:
            return sum(spans) / 1e6 / iters, len(spans) / iters
    raise RuntimeError(f"torch.profiler recorded no {names} kernel in {PROFILE_TRIES} tries")


def x0_bound(wide_per_element: int, out: torch.Tensor, *inputs) -> tuple[float, str]:
    """X0's least time: its wide multiplies on every output element, and the
    int64 limbs of each input read once (an operand's own elements, not its
    broadcast) and of the output written once."""
    own = sum(int(np.prod([s for s, st in zip(x.shape[1:], x.stride()[1:]) if st]))
              for x in inputs)
    n = out[0].numel()
    return bound_ms(n * wide_per_element, 0, LIMB_FE * (n + own))


def pow_wide(exponent: int) -> int:
    """The chain's wide multiplies an element: a squaring per bit, a product per set bit."""
    return max(1, exponent.bit_length()) * SQR + bin(exponent).count("1") * MUL


# X0c's own work an element (csrc/field_ops.cuh inv): 25 matrix updates of
# (d, e) and (f, g), 9 limbs each, 6 and 4 signed 32 x 32 -> 64 products a
# limb and 4 for the corrections, then the product by R^3
INV_WIDE = 25 * (9 * 6 + 9 * 4 + 4) + MUL
X0_KERNEL_NAMES = {"x0a": ("mont_mul_kernel",), "x0b": ("linear_kernel",),
                   "x0c": ("inv_kernel",), "x0c_pow": ("pow_kernel",), "x1": ("ntt_pass_kernel",)}


class DomainX0a:
    """Within the block, counts the X0a launches made inside each of the
    Domain's four transforms (the factors are folded into X1, so 0 each)."""

    METHODS = DOMAIN_METHODS

    def __enter__(self):
        from circuits_halo2_tpu_torch.ops import field_torch as FT
        from circuits_halo2_tpu_torch.utils import poly_device as PD

        self.cls, self.saved, self.calls, self.x0a = PD.Domain, {}, {}, {}
        for name in self.METHODS:
            self.saved[name] = fn = getattr(PD.Domain, name)
            self.calls[name] = self.x0a[name] = 0

            def counted(dom, *args, _fn=fn, _name=name, **kwargs):
                before = FT.mont_mul.launches
                out = _fn(dom, *args, **kwargs)
                self.calls[_name] += 1
                self.x0a[_name] += FT.mont_mul.launches - before
                return out

            setattr(PD.Domain, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)
        return False


def x1_bound(rows: int, n: int) -> tuple[float, str]:
    """X1's least time for ``rows`` transforms of n points: the products a
    radix-2 transform cannot skip, (n / 2) log2(n) less the n - 1 whose
    twiddle is 1, a row, and the int64 limbs read once and written once."""
    logn = n.bit_length() - 1
    return bound_ms(rows * ((n // 2) * logn - (n - 1)) * MUL, 0, LIMB_FE * 2 * rows * n)


def x0_x1_timings(device, art, circuit, card) -> dict:
    """X0a-X0c, the chain and X1 against their plain versions at the k=13
    prover's shapes: 8 columns of its extended domain against a lane table,
    the inversion of three grand-product denominators (and the chain on
    them), and the NTT of those columns. Each kernel's time is its device
    time (``device_ms``: the profiler's kernel durations, 10 calls), beside
    the wrapper's (CUDA events over 5 back-to-back calls, host time
    included); the plain version one call. X1's row is per launch (a 2^16
    transform is two), as its launches are. Logs each one's launches in one
    more k=13 prove first, and requires that the Domain's transforms in it
    launch no X0a."""
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.utils import pipeline
    from circuits_halo2_tpu_torch.utils import poly_device as PD

    keys = ("x0a", "x0b", "x0c", "x0c_pow", "x1")
    wrappers = (FT.mont_mul, FT.linear, FT.inv_mont, FT.mont_pow, NTT.ntt_passes)
    before = [w.launches for w in wrappers]
    with DomainX0a() as domain:
        pipeline.full_prover(art, circuit, circuit.instances())
    log("one k=13 prove: " + ", ".join(f"{key.upper()} {w.launches - b} launches"
                                       for key, w, b in zip(keys, wrappers, before)))
    log("its Domain transforms (calls, X0a launches inside them): " + ", ".join(
        f"{name} {domain.calls[name]}, {domain.x0a[name]}" for name in DomainX0a.METHODS))
    require(not any(domain.x0a.values()), "a Domain transform launched X0a")
    require(all(domain.calls[name] for name in ("coeff_to_extended", "lagrange_to_coeff",
                                                "vanishing_to_coeff")),
            "the prove made none of the Domain's transforms")

    rng = np.random.default_rng(SEED + 13)
    dom = PD.domain(CRITERION[3], art.pk.vk.cs.degree(), str(device))
    n = dom.n_ext
    cols, lanes = mont_limbs(device, rng, (1, 8, n)), mont_limbs(device, rng, (1, 1, n))
    z, e = mont_limbs(device, rng, (1, 3, 1)), FT.FR.mod_int - 2
    prod = FT.mont_mul(cols, lanes)
    logn = n.bit_length() - 1
    calls = {
        "x0a": (lambda: FT.mont_mul(cols, lanes), lambda: FT.mont_mul_ref(cols, lanes),
                x0_bound(MUL, prod, cols, lanes)),
        "x0b": (lambda: FT.add_mod(cols, lanes), lambda: FT.add_mod_ref(cols, lanes),
                x0_bound(0, prod, cols, lanes)),
        "x0c": (lambda: FT.inv_mont(z), lambda: FT.mont_pow_ref(z, e), x0_bound(INV_WIDE, z, z)),
        "x0c_pow": (lambda: FT.mont_pow(z, e), lambda: FT.mont_pow_ref(z, e),
                    x0_bound(pow_wide(e), z, z)),
        "x1": (lambda: NTT.ntt(cols, dom.omega_ext), lambda: NTT.ntt_ref(cols, dom.omega_ext),
               x1_bound(8, n)),
    }
    what = {"x0a": f"mont_mul (16, 1, 8, 2^{logn}) x (16, 1, 1, 2^{logn})",
            "x0b": f"add_mod (16, 1, 8, 2^{logn}) x (16, 1, 1, 2^{logn})",
            "x0c": "inv_mont (16, 1, 3, 1) (a latency: three threads)",
            "x0c_pow": "mont_pow (16, 1, 3, 1) at p - 2, the chain inv_mont ran before",
            "x1": f"ntt (16, 1, 8, 2^{logn})"}
    out = {}
    for key, (fn, plain, (bound, by)) in calls.items():
        dev_ms, per_call = device_ms(fn, 10, X0_KERNEL_NAMES[key])
        wrap_ms = cuda_ms(fn, 5)
        plain_ms = cuda_ms(plain, 1, warm=False)
        per = max(per_call, 1.0)  # launches a call: X1's time, bound and plain per launch
        out[key] = [dev_ms / per, plain_ms / per, bound / per, by]
        log(f"{key.upper()} {what[key]}: device {dev_ms:.4f} ms a call in {per_call:g} "
            f"launches, wrapper {wrap_ms:.4f} ms, plain torch {plain_ms:.3f} ms, bound "
            f"{bound:.4f} ms ({by}; share {bound / dev_ms:.1%}) ({card})")
    return out


def x4_ceremony(device) -> dict:
    """X4 against its plain version, limb for limb, at hermez-raw-11's first
    2^10 monomial points, the scaled inverse that its downsize runs, where
    kernel and plain version are timed (CUDA events; the plain version one
    launch). Returns the largest limb difference and the timings."""
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field as F
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.utils import ec_fft as EC
    from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

    k = 10
    ceremony = ParamsKZG.read(str(TESTS / "fixtures_ptau_hermez-raw-11"))
    transforms = [(F.fr_inv(NTT.omega_for_k(k)), F.fr_inv(1 << k))]
    args = EC.transform_inputs(ceremony.g[: 1 << k], transforms, device)
    got = EK.ec_fft(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = EK.ec_fft_ref(*args)
    end.record()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)),
            "X4 differs from its plain version at the ceremony downsize (n=2^10)")
    return {"x4_err": err, "x4": [cuda_ms(lambda: EK.ec_fft(*args), 3), start.elapsed_time(end),
                                  *x4_glv_bound(1 << k, transforms),
                                  x4_bound(1 << k, transforms)[0]]}


def x4_full_width(device) -> int:
    """X4 against its plain version, limb for limb, at the other shape the
    main path hands it: the scaled inverse of 2^13 points of a setup (the
    2^17 -> 2^13 downsize). Returns the largest limb difference."""
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field as F
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.utils import ec_fft as EC
    from circuits_halo2_tpu_torch.utils.srs import setup_cached

    k = CRITERION[3]
    transforms = [(F.fr_inv(NTT.omega_for_k(k)), F.fr_inv(1 << k))]
    args = EC.transform_inputs(setup_cached(k).g, transforms, device)
    got, want = EK.ec_fft(*args), EK.ec_fft_ref(*args)
    err = max_abs_err(got, want)
    require(err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)),
            "X4 differs from its plain version at the full-width downsize (n=2^13)")
    return err


def x4_bound(n: int, transforms) -> tuple[float, str]:
    """The least time for the reference's work on these transforms, beside
    X4's own (``x4_glv_bound``): the fewest products of each butterfly's
    double-and-add by its twiddle (a doubling per bit below the top one, a
    complete add per set bit after the first) and of its two adds, and of
    the scale pass; the bytes of the points in and out, the twiddles and
    the scales."""
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field as F

    def smul(k: int) -> int:
        k %= F.FR_MOD
        return 0 if k == 0 else (k.bit_length() - 1) * DBL_WIDE + (bin(k).count("1") - 1) * ADD_WIDE

    wide = 0
    for omega, scale in transforms:
        twiddles = EK.twiddles(n, omega % F.FR_MOD)
        for s in range(n.bit_length() - 1):
            butterflies = n >> (s + 1)  # per twiddle of the stage
            wide += sum(butterflies * (smul(w) + 2 * ADD_WIDE)
                        for w in twiddles[(1 << s) - 1 : (2 << s) - 1])
        if scale % F.FR_MOD != 1:
            wide += n * smul(scale)
    nbytes = len(transforms) * (2 * n * 3 * FE + (n - 1) * FE + FE)
    return bound_ms(wide, 0, nbytes)


def glv_half_work(digits: np.ndarray) -> np.ndarray:
    """Wide multiplies of each GLV half's windowed multiply in X4 (its digits
    along the last axis): the table T_2..T_m for m its largest |digit| (a
    doubling for even m, a complete add for odd), four doublings per digit
    below the top nonzero one, a complete add per nonzero digit below it."""
    d = np.abs(digits.astype(np.int64))
    nz = d != 0
    nd = d.shape[-1]
    top = np.where(nz.any(-1), nd - 1 - np.argmax(nz[..., ::-1], axis=-1), -1)
    table = np.cumsum([0, 0] + [DBL_WIDE if m % 2 == 0 else ADD_WIDE for m in range(2, 9)])
    below = np.maximum(top, 0)
    return table[d.max(-1)] + 4 * below * DBL_WIDE + (nz.sum(-1) - (top >= 0)) * ADD_WIDE


def x4_glv_bound(n: int, transforms) -> tuple[float, str]:
    """X4's least time for the work its design does on these transforms: per
    butterfly both halves' windowed multiplies (``glv_half_work``), phi's
    product, V = R_0 + R_1 once and the two butterfly adds; per scaled point
    both halves, phi and one add. A half whose digits are all 0 is infinity:
    it needs no phi, and an add with it no product. Bytes: the points in and
    out, the digits and beta."""
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field as F

    def work(digits: np.ndarray) -> np.ndarray:
        live = (digits != 0).any(-1)  # (..., 2): the halves that are not infinity
        return (glv_half_work(digits).sum(-1) + MUL * live[..., 1]
                + ADD_WIDE * live.all(-1))

    wide = 0
    for omega, scale in transforms:
        digits = EK.twiddle_digits(n, omega % F.FR_MOD)
        per = work(digits) + 2 * ADD_WIDE * (digits != 0).any((-1, -2))
        for s in range(n.bit_length() - 1):
            butterflies = n >> (s + 1)  # per twiddle of the stage
            wide += butterflies * int(per[(1 << s) - 1 : (2 << s) - 1].sum())
        if scale % F.FR_MOD != 1:
            wide += n * int(work(EK.scalar_digits([scale])).sum())
    # a transform's n - 1 twiddles' and one scale's digits: n (2, DIGITS) int8 rows
    nbytes = len(transforms) * (2 * n * 3 * FE + n * 2 * EK.DIGITS) + FE
    return bound_ms(wide, 0, nbytes)


def x4_analytic(device, report) -> None:
    """X4 where the card is full: ``g_to_lagrange`` of setup(16)'s 2^16
    monomial bases through X4 equals its analytic Lagrange bases, every
    point; then X4 on those inputs is timed (CUDA events, 3 warm calls)."""
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field as F
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.utils import ec_fft as EC
    from circuits_halo2_tpu_torch.utils.srs import setup_cached

    k, n = X4_BIG, 1 << X4_BIG
    params = setup_cached(k)
    require(EC.g_to_lagrange(params.g, k, device) == params.g_lagrange,
            f"X4 differs from setup({k})'s analytic Lagrange bases")
    transforms = [(F.fr_inv(NTT.omega_for_k(k)), F.fr_inv(n))]
    args = EC.transform_inputs(params.g, transforms, device)
    report["x4_big"] = [cuda_ms(lambda: EK.ec_fft(*args), 3), *x4_glv_bound(n, transforms),
                        x4_bound(n, transforms)[0]]
    log(f"X4 n=2^{k} (g_to_lagrange of setup({k}).g): equal to the analytic Lagrange bases; "
        f"{report['x4_big'][0]:.3f} ms, bound {report['x4_big'][1]:.3f} ms (the reference's "
        f"double-and-add {report['x4_big'][3]:.3f} ms)")


def poseidon_engine(device, digests, balances, host_root):
    """The Poseidon engine's entry points at the criterion tree's width."""
    from circuits_halo2_tpu_torch.merkle.device_tree import tree_root_mxu
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import poseidon as PS
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP

    with Phase("criterion tree 2^20 root through K4 (raw residues)"):
        root = tree_root_mxu(digests, balances, device)
        require(root == host_root, f"K4 tree root {root} != host root {host_root}")
        log(f"K4 root {hex(root[0])} == host root")
    with Phase("K2 permutation of the 2^20 leaf states"):
        p = FT.FR.mod_int
        users = [int.from_bytes(d.tobytes(), "big") % p for d in digests]
        sums = [int(b) for b in balances[:, 0]]
        s0 = torch.as_tensor(FT.to_mont_limbs(users), device=device)
        s1 = torch.as_tensor(FT.to_mont_limbs(sums), device=device)
        o0, o1 = PK.permute(s0, s1)
        got = list(zip(FT.from_mont_ints(o0[:, :16]), FT.from_mont_ints(o1[:, :16])))
        require(got == [tuple(PS.permute([u, b])) for u, b in zip(users[:16], sums[:16])],
                "K2 differs from the host permutation")
        log("K2 2^20 states: first 16 == host poseidon.permute")
    with Phase("K5/K6 probe experiment (exp_poseidon_mxu)"):
        results = EXP.run_variants(["check", *EXP.VARIANTS], device)
        for r in results:
            log(json.dumps(r))
    return results


def host_tree_root(digests: np.ndarray, balances: np.ndarray):
    """Root of the tree of (digest, balances) leaves by the native host
    sponge (``bench_suite.host_tree_root``)."""
    from circuits_halo2_tpu_torch.bench_suite import host_tree_root as root

    return root(digests, balances)


def first_difference(got: str, want: str) -> str:
    """Where two hex strings first differ, for a failure message."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    return f"first differing byte {i // 2} of {len(got) // 2} (expected {len(want) // 2})"


def synthetic_proofs(art, fix: dict, name: str) -> None:
    """Both transcripts' proofs of a fixture's seeded synthetic witness
    (``synthetic_merkle_proof``) equal the JAX package's byte for byte."""
    from circuits_halo2_tpu_torch.merkle.mst import Entry, synthetic_merkle_proof
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.utils import pipeline

    witness = synthetic_merkle_proof(fix["levels"], fix["n_currencies"],
                                     Entry(fix["user"], fix["balances"]), seed=fix["seed"])
    circuit = MstInclusionCircuit.init(fix["levels"], fix["n_currencies"], fix["n_bytes"], witness)
    instances = circuit.instances()
    require([[hex(v) for v in col] for col in instances] == fix["instances"],
            f"{name} synthetic witness: instances differ from the fixture")
    with Phase(f"{name} Keccak proof of the synthetic witness (gen_proof_solidity_calldata)"):
        got = pipeline.gen_proof_solidity_calldata(art, circuit).proof[2:]
        require(got == fix["keccak_proof"],
                f"{name} Keccak proof differs from the JAX package's: "
                + first_difference(got, fix["keccak_proof"]))
        log(f"{name} Keccak proof {len(got) // 2} B == JAX fixture")
    with Phase(f"{name} Blake2b proof of the synthetic witness (full_prover)"):
        got = pipeline.full_prover(art, circuit, instances).hex()
        require(got == fix["blake2b_proof"],
                f"{name} Blake2b proof differs from the JAX package's: "
                + first_difference(got, fix["blake2b_proof"]))
        require(pipeline.full_verifier(art, bytes.fromhex(got), instances),
                f"{name} Blake2b proof does not verify")
        log(f"{name} Blake2b proof {len(got) // 2} B == JAX fixture, verifies")


def verify_and_flip(art, proof: bytes, instances, name: str, transcript_cls=None) -> None:
    """The proof verifies (under Blake2b unless ``transcript_cls`` says
    otherwise); a flipped instance and a flipped proof byte are rejected."""
    from circuits_halo2_tpu_torch.models.verifier import verify
    from circuits_halo2_tpu_torch.utils.transcript import Blake2bTranscript

    def verifies(p, inst) -> bool:  # a malformed proof raises, as in pipeline.full_verifier
        try:
            return verify(art.params, art.vk, inst, p,
                          transcript_cls=transcript_cls or Blake2bTranscript)
        except (ValueError, AssertionError, KeyError):
            return False

    require(verifies(proof, instances), f"{name} proof does not verify")
    bad = [list(instances[0])]
    bad[0][2] += 1
    require(not verifies(proof, bad), f"{name} proof verifies against a flipped instance")
    flipped = bytearray(proof)
    flipped[len(proof) // 2] ^= 1
    require(not verifies(bytes(flipped), instances), f"{name} proof verifies with a flipped byte")
    log(f"{name} proof {len(proof)} B verifies; flipped instance and flipped byte rejected")


def criterion(device):
    """Reference criterion config: 2^20 entries, LEVELS=20, k=13; then its
    sorted build, and the JAX package's proofs of the synthetic witness."""
    from circuits_halo2_tpu_torch.merkle.device_tree import (build_device_tree,
                                                             build_device_tree_sorted)
    from circuits_halo2_tpu_torch.merkle.mst import Entry
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.utils import pipeline

    levels, ncur, nbytes, k = CRITERION
    n = 1 << levels
    entry0 = Entry(USER, [11888])
    rng = np.random.default_rng(SEED)
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    digests[0] = np.frombuffer(entry0.hashed_username.to_bytes(32, "big"), dtype=np.uint8)
    balances = rng.integers(0, 1 << 40, size=(n, ncur), dtype=np.uint64)
    balances[0, 0] = entry0.balances[0]
    usernames = rng.integers(0, 256, size=(n, 8), dtype=np.uint8).view("S8")[:, 0]

    with Phase("criterion tree 2^20 on device"):
        tree = build_device_tree(digests, balances, device)
        root = tree.root()
    with Phase("criterion tree 2^20 host reference"):
        host_root = host_tree_root(digests, balances)
        if root != host_root:
            raise AssertionError(f"device root {root} != host root {host_root}")
        log(f"root {hex(root[0])} balances {root[1]} == host")

    with Phase("criterion setup + keygen k=13"):
        art = pipeline.generate_setup_artifacts(k, None, levels, ncur, nbytes, device)
    with Phase("criterion prove k=13 (full_prover, Blake2b)"):
        circuit = MstInclusionCircuit.init(levels, ncur, nbytes, tree.generate_proof(0, entry0))
        instances = circuit.instances()
        proof = pipeline.full_prover(art, circuit, instances)
    with Phase("criterion verify k=13"):
        verify_and_flip(art, proof, instances, "criterion")
    synthetic_proofs(art, json.loads(CRITERION_FIXTURE.read_text())["criterion"], "criterion")

    with Phase("criterion sorted tree 2^20 on device (build_device_tree_sorted)"):
        stree, order = build_device_tree_sorted(usernames, digests, balances, device)
        sroot = stree.root()
    with Phase("criterion sorted tree host reference"):
        require(sroot[1] == root[1], f"sorted root balances {sroot[1]} != {root[1]}")
        ordered = usernames[order]
        require(bool((ordered[:-1] <= ordered[1:]).all()),
                "build_device_tree_sorted did not sort the usernames")
        require(sroot == host_tree_root(digests[order], balances[order]),
                "sorted device root differs from the host root of the permuted leaves")
        log(f"sorted root {hex(sroot[0])} == host root of the permuted leaves, "
            f"balances {sroot[1]} == unsorted")
    entries = [entry0] + [tree_entry(digests, balances, i) for i in range(1, BATCH_USERS)]
    return digests, balances, host_root, circuit, art, tree, entries, proof


def tree_entry(digests, balances, index: int):
    """The host Entry of leaf ``index`` of a tree built from raw digests:
    its username digest is the leaf's (there is no username behind it)."""
    from circuits_halo2_tpu_torch.merkle.mst import Entry

    entry = Entry.__new__(Entry)
    entry.username = f"leaf{index}"
    entry.balances = [int(b) for b in balances[index]]
    entry.hashed_username = int.from_bytes(digests[index].tobytes(), "big")
    return entry


def batch_prover(device, art, tree, entries, blake2b_0: bytes, card) -> None:
    """Users 0-7 of the criterion tree (k=13): one traced prove, users 0-3
    proved one at a time with ``prove`` (Keccak), then users 0-7 with
    ``prove_batch`` at U=4 (two calls) and U=8 (one call): every batch
    proof of users 0-3 equals the single proof byte for byte, those of
    users 4-7 equal between U=4 and U=8, and the single proofs verify.
    Then users 0 and 1 with Blake2b at U=2: user 0's proof equals the
    criterion phase's ``full_prover`` proof of the same witness
    (``blake2b_0``), and both verify. Every call is warm (the criterion
    phase proved on the same key). Logs the proofs per minute and each
    batch size's peak device memory."""
    import contextlib
    import io
    import os

    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.models.prover import prove
    from circuits_halo2_tpu_torch.models.prover_batch import prove_batch
    from circuits_halo2_tpu_torch.models.verifier import verify
    from circuits_halo2_tpu_torch.utils.transcript import Blake2bTranscript

    levels, ncur, nbytes, _ = CRITERION
    circuits = [MstInclusionCircuit.init(levels, ncur, nbytes, tree.generate_proof(i, e))
                for i, e in enumerate(entries)]
    instances = [c.instances() for c in circuits]
    users = len(circuits)

    def single(u, **kw):
        return prove(art.params, art.pk, circuits[u], art.config, instances[u], device, **kw)

    def batch(us, **kw):
        return prove_batch(art.params, art.pk, [circuits[u] for u in us], art.config,
                           [instances[u] for u in us], device=device, **kw)

    with Phase(f"batch: one traced prove k={CRITERION[3]} (CIRCUITS_PROVE_TRACE=1)"):
        err = io.StringIO()
        os.environ["CIRCUITS_PROVE_TRACE"] = "1"
        try:
            with contextlib.redirect_stderr(err):
                single(0)
        finally:
            del os.environ["CIRCUITS_PROVE_TRACE"]
        for line in err.getvalue().splitlines():
            log(f"  {line} ({card})")
    per_minute = {}
    with Phase(f"batch: users 0-{SINGLE_USERS - 1} one at a time with prove (Keccak)"):
        t0 = time.perf_counter()
        singles = [single(u) for u in range(SINGLE_USERS)]
        torch.cuda.synchronize()
        per_minute["sequential"] = SINGLE_USERS * 60 / (time.perf_counter() - t0)
    with Phase(f"batch: the {SINGLE_USERS} single proofs verify"):
        for u in range(SINGLE_USERS):
            require(verify(art.params, art.vk, instances[u], singles[u]),
                    f"single proof of user {u} does not verify")
        bad = [list(instances[0][0])]
        bad[0][2] += 1
        require(not verify(art.params, art.vk, bad, singles[0]),
                "a single proof verifies against a flipped instance")
    first = None  # the first batch size's proofs, for users without a single proof
    for size in BATCH_SIZES:
        with Phase(f"batch: prove_batch U={size}, {users // size} call(s) (Keccak)"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            proofs = [p for start in range(0, users, size)
                      for p in batch(range(start, start + size))]
            torch.cuda.synchronize()
            per_minute[f"U={size}"] = users * 60 / (time.perf_counter() - t0)
            want = singles + (first or proofs)[SINGLE_USERS:]
            for u in range(users):
                require(proofs[u] == want[u],
                        f"U={size} batch proof of user {u} differs from its "
                        + ("single proof: " if u < SINGLE_USERS else "first batch proof: ")
                        + first_difference(proofs[u].hex(), want[u].hex()))
            first = first or proofs
            log(f"U={size}: users 0-{SINGLE_USERS - 1} == the single proofs (which verify), "
                f"users {SINGLE_USERS}-{users - 1} == U={BATCH_SIZES[0]}'s; peak "
                f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
                f"{base} B held before the call ({card})")
    with Phase("batch: users 0 and 1 with Blake2b at U=2"):
        b_batch = batch((0, 1), transcript_cls=Blake2bTranscript)
        require(b_batch[0] == blake2b_0,
                "Blake2b U=2 proof of user 0 differs from the criterion phase's full_prover proof")
        for u in (0, 1):
            require(verify(art.params, art.vk, instances[u], b_batch[u],
                           transcript_cls=Blake2bTranscript),
                    f"Blake2b batch proof of user {u} does not verify")
        log("Blake2b U=2: user 0 == the criterion full_prover proof; both verify")
    log(f"batch k={CRITERION[3]} proofs per minute: "
        + ", ".join(f"{key} {value:.3f}" for key, value in per_minute.items()) + f" ({card})")


def round_accounts(n: int, ncur: int, rounds: int):
    """``n`` seeded usernames (10 lowercase letters, as bytes) and
    ``rounds`` draws of their balances below ``ROUND_BALANCE_CAP``, from one
    generator: the operator's round takes the first draw, the incremental
    chain all three."""
    rng = np.random.default_rng(SEED)
    names = (rng.integers(0, 26, size=(n, 10), dtype=np.uint8) + ord("a")).view("S10")[:, 0]
    return names, [rng.integers(0, ROUND_BALANCE_CAP, size=(n, ncur), dtype=np.uint64)
                   for _ in range(rounds)]


def operator_round(device, card) -> np.ndarray:
    """The operator's round at the criterion width: a 2^20-entry
    ``MerkleSumTree.from_entries`` of seeded string usernames (its root
    equal to ``build_device_tree``'s over the same leaves), ``Round`` on a
    k=13 SRS file, the ownership proofs, the commitment, two users'
    inclusion proofs with the user-side checks, and the verifier generated
    from the VK accepting both in the Yul VM and rejecting a flipped byte.
    Returns the usernames' keccak digests, (2^20, 32) bytes."""
    from circuits_halo2_tpu_torch import build
    from circuits_halo2_tpu_torch.backend.address_ownership import AddressOwnership
    from circuits_halo2_tpu_torch.backend.apis import leaf_hash_from_inputs
    from circuits_halo2_tpu_torch.backend.round import Round
    from circuits_halo2_tpu_torch.backend.signer import SummaSigner
    from circuits_halo2_tpu_torch.contracts.sol_generator import SolidityGenerator
    from circuits_halo2_tpu_torch.contracts.summa_sim import Cryptocurrency, SummaContractSim
    from circuits_halo2_tpu_torch.contracts.yul_vm import estimate_code_size, run_verifier_gas
    from circuits_halo2_tpu_torch.merkle.device_tree import build_device_tree
    from circuits_halo2_tpu_torch.merkle.mst import Entry, MerkleSumTree
    from circuits_halo2_tpu_torch.models.verifier import verify
    from circuits_halo2_tpu_torch.utils.srs import setup_cached
    from circuits_halo2_tpu_torch.utils.transcript import KeccakTranscript

    levels, ncur, nbytes, k = CRITERION
    n = 1 << levels
    names, (balances,) = round_accounts(n, ncur, 1)
    with Phase(f"round: 2^{levels} entries, MerkleSumTree.from_entries on the card (K1)"):
        entries = [Entry(name.decode(), [int(b) for b in bal])
                   for name, bal in zip(names, balances)]
        mst = MerkleSumTree.from_entries(entries, [Cryptocurrency("ETH", "ETH")], device)
    with Phase("round: the same leaves through build_device_tree"):
        digests = np.frombuffer(b"".join(e.hashed_username.to_bytes(32, "big") for e in entries),
                                dtype=np.uint8).reshape(n, 32)
        root = build_device_tree(digests, balances, device).root()
        require(root == (mst.root.hash, list(mst.root.balances)),
                f"MerkleSumTree root {mst.root} != build_device_tree root {root}")
        log(f"round tree root {hex(root[0])} balances {root[1]} == build_device_tree's")
    srs = build.build_dir() / f"round-srs-{k}"  # Snapshot reads k from the name's suffix
    setup_cached(k).write(str(srs))

    box = {}

    def onchain_verifier(proof, inputs):
        art = box["artifacts"]
        return verify(art.params, art.vk, [inputs], proof, transcript_cls=KeccakTranscript)

    summa = SummaContractSim(onchain_verifier, levels, ncur, nbytes)
    signer = SummaSigner("0x" + "11" * 32, summa, sender=summa.owner)
    timestamp = 1
    with Phase(f"round: Round (setup + keygen k={k}), ownership proofs, commitment"):
        round_ = Round(signer, mst, str(srs), timestamp, levels, ncur, nbytes, device=device)
        art = box["artifacts"] = round_.snapshot.trusted_setup
        AddressOwnership(signer, str(TESTS / "fixtures_csv" / "signatures.csv")) \
            .dispatch_proof_of_address_ownership()
        round_.dispatch_commitment()
        require(len(summa.address_ownership_proofs) == 2
                and summa.commitments[timestamp].mst_root == mst.root.hash,
                "the ownership proofs or the commitment did not land")
    proofs = {}
    for user in ROUND_USERS:
        with Phase(f"round: get_proof_of_inclusion({user}) and the user-side checks"):
            proof = round_.get_proof_of_inclusion(user)
            inputs = [int(v, 16) for v in proof.public_inputs]
            entry = mst.entries[user]
            require(leaf_hash_from_inputs(entry.username, [str(b) for b in entry.balances])
                    == inputs[0], f"user {user}: leaf hash mismatch")
            require(summa.commitments[timestamp].mst_root == inputs[1],
                    f"user {user}: root mismatch")
            proofs[user] = (bytes.fromhex(proof.proof_calldata[2:]), inputs)
            require(summa.verify_inclusion_proof(proofs[user][0], inputs, timestamp),
                    f"user {user}: verifyInclusionProof failed")
            log(f"user {user}: leaf hash, on-chain root and verifyInclusionProof pass")
    with Phase("round: generated EVM verifier in the Yul VM"):
        source = SolidityGenerator(art.params, art.vk, 2 + ncur).render()
        for user, (proof, inputs) in proofs.items():
            ok, gas = run_verifier_gas(source, proof, inputs)
            require(ok, f"the generated verifier rejects user {user}'s proof")
            log(f"user {user}: generated verifier accepts, run_verifier_gas {gas}")
        proof, inputs = proofs[ROUND_USERS[0]]
        bad = bytearray(proof)
        bad[300] ^= 1
        require(not run_verifier_gas(source, bytes(bad), inputs)[0],
                "the generated verifier accepts a proof with a flipped byte")
        log(f"flipped byte rejected; estimate_code_size {estimate_code_size(source)} B, "
            f"source {len(source)} characters ({card})")
    return digests


def chain_checks(art, chain, name: str) -> None:
    """Both chain verifiers accept ``chain`` and reject it with a flipped
    byte in step 2's proof and with a broken chaining instance."""
    import copy

    from circuits_halo2_tpu_torch.models import incremental as INC

    require(INC.verify_chain(art, chain), f"{name}: verify_chain rejects the chain")
    require(INC.verify_chain_compressed(art, chain),
            f"{name}: verify_chain_compressed rejects the chain")
    flipped = copy.deepcopy(chain)
    proof = bytearray(flipped.steps[1].proof)
    proof[100] ^= 1
    flipped.steps[1] = INC.IncrementalStep(bytes(proof), flipped.steps[1].instances)
    broken = copy.deepcopy(chain)
    broken.steps[1].instances[0][0] ^= 1
    for what, bad in (("a flipped byte in step 2", flipped), ("a broken chaining", broken)):
        require(not INC.verify_chain(art, bad), f"{name}: verify_chain accepts {what}")
        require(not INC.verify_chain_compressed(art, bad),
                f"{name}: verify_chain_compressed accepts {what}")
    log(f"{name}: {len(chain.steps)} steps verify (per step and with one pairing); "
        "a flipped byte in step 2 and a broken chaining are rejected by both")


def _hex_rows(rows) -> list[list[str]]:
    return [[hex(v) for v in col] for col in rows]


def _require_hex(got: str, want: str, what: str) -> None:
    require(got == want, f"{what} differs from the JAX package's: " + first_difference(got, want))


def incremental_parity(device) -> None:
    """The reference example's size (entry_16 rounds 1-3, LEVELS=4, two
    currencies): the step chain at k=11 and the chained SNARK at k=13
    equal the JAX package's bytes (fixtures (a) and (b))."""
    from circuits_halo2_tpu_torch.models import incremental as INC
    from circuits_halo2_tpu_torch.utils import pipeline

    fix = json.loads(INCREMENTAL_FIXTURE.read_text())
    steps, snark = fix["steps"], fix["snark"]
    states = [str(TESTS / p) for p in steps["csvs"]]
    shape = (steps["levels"], steps["n_currencies"], steps["n_bytes"])
    with Phase("incremental entry_16: setup + keygen of the step circuit k=11"):
        art = pipeline.generate_incremental_artifacts(steps["k"], str(TESTS / steps["ptau"]),
                                                      *shape, device=device)
        require([[hex(x), hex(y)] for x, y in art.vk.fixed_commitments] == steps["fixed_comms"]
                and [[hex(x), hex(y)] for x, y in art.vk.permutation_commitments]
                == steps["permutation_comms"],
                "step-circuit VK commitments differ from the JAX package's")
        log(f"{len(steps['fixed_comms'])} fixed + {len(steps['permutation_comms'])} permutation "
            "commitments == JAX fixture")
    with Phase("incremental entry_16: prove_chain, 3 rounds (trees K1, proofs K3)"):
        chain = INC.prove_chain(art, states, steps["user_index"])
        for i, (step, want) in enumerate(zip(chain.steps, steps["proofs"])):
            _require_hex(step.proof.hex(), want, f"entry_16 step {i + 1} proof")
        require([_hex_rows(s.instances) for s in chain.steps] == steps["instances"]
                and [hex(v) for v in chain.user_states] == steps["user_states"]
                and [hex(v) for v in chain.liab_states] == steps["liab_states"],
                "entry_16 chain instances or states differ from the JAX package's")
        log(f"3 step proofs of {len(chain.steps[0].proof)} B == JAX fixture")
    with Phase("incremental entry_16: verify_chain, verify_chain_compressed, rejections"):
        chain_checks(art, chain, "entry_16 chain")
    with Phase("incremental entry_16: chained SNARK k=13 (setup + keygen, prove_chain_snark)"):
        cart = pipeline.generate_chained_artifacts(snark["k"], None, *shape,
                                                   nsteps=snark["nsteps"], device=device)
        proof, inst = INC.prove_chain_snark(cart, states, snark["user_index"])
        _require_hex(proof.hex(), snark["proof"], "entry_16 chained SNARK")
        require(_hex_rows(inst) == snark["instances"], "chained SNARK instances differ")
    with Phase("incremental entry_16: verify_chain_snark"):
        roots = [int(v, 16) for v in snark["roots"]]
        leaves = [int(v, 16) for v in snark["leaf_hashes"]]
        require(INC.verify_chain_snark(cart, proof, inst, roots, leaves),
                "verify_chain_snark rejects the chained SNARK")
        require(not INC.verify_chain_snark(cart, proof, inst, roots[:2]),
                "verify_chain_snark accepts a truncated root list")
        log(f"chained SNARK {len(proof)} B == JAX fixture; verifies against the rounds' roots "
            "and leaf hashes; a truncated root list is rejected")


class Clocked:
    """Adds the wall time (after a device sync) of every call of
    ``owner.name`` to ``self.seconds`` while the block runs."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.seconds, self.calls = owner, name, 0.0, 0

    def __enter__(self):
        self.saved = vars(self.owner)[self.name]
        fn = getattr(self.owner, self.name)

        def clocked(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(self.owner, self.name, clocked)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)
        return False


def incremental_criterion(device, card, digests: np.ndarray):
    """The criterion width on real data: three seeded 2^20-entry rounds in
    the ``username;balances`` format (the operator round's usernames,
    balances redrawn per round), the step circuit at k=13 and
    ``prove_chain`` for user 777,777 (three ``from_entries`` trees through
    K1, three proofs through K3), both verifiers and their rejections, and
    the final states recomputed on the host from each round's root
    (``build_device_tree`` over the same leaves, with the usernames' digests
    ``digests`` from the operator's round) and the user's leaf hash."""
    from circuits_halo2_tpu_torch import build
    from circuits_halo2_tpu_torch.merkle.device_tree import build_device_tree
    from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree
    from circuits_halo2_tpu_torch.models import incremental as INC
    from circuits_halo2_tpu_torch.ops import poseidon
    from circuits_halo2_tpu_torch.utils import pipeline

    levels, ncur, nbytes, k = CRITERION
    n = 1 << levels
    require(n * (ROUND_BALANCE_CAP - 1) < 1 << (8 * nbytes),
            "a round's balance sums would not fit N_BYTES")
    with Phase(f"incremental criterion: write {CHAIN_ROUNDS} seeded 2^{levels}-entry round CSVs"):
        names, rounds = round_accounts(n, ncur, CHAIN_ROUNDS)
        users = names.astype(f"U{names.dtype.itemsize}").tolist()
        csvs = []
        for r, balances in enumerate(rounds, 1):
            path = build.build_dir() / f"incremental-round-{r}.csv"
            rows = (f"{u};{','.join(map(str, b))}" for u, b in zip(users, balances.tolist()))
            path.write_text("username;balances\n" + "\n".join(rows) + "\n")
            csvs.append(str(path))
        log(f"rounds at {', '.join(csvs)}; balances below {ROUND_BALANCE_CAP} "
            f"(calculate_max_root_balance({nbytes}, {levels}) = "
            f"{pipeline.calculate_max_root_balance(nbytes, levels)})")
    with Phase(f"incremental criterion: setup + keygen of the step circuit k={k}"):
        art = pipeline.generate_incremental_artifacts(k, None, levels, ncur, nbytes, device=device)
    with Phase(f"incremental criterion: prove_chain, {CHAIN_ROUNDS} rounds, user {CHAIN_USER}"):
        with Clocked(MerkleSumTree, "from_entries") as trees, \
                Clocked(pipeline, "full_prover") as proofs:
            chain = INC.prove_chain(art, csvs, CHAIN_USER)
        require(trees.calls == proofs.calls == CHAIN_ROUNDS, "prove_chain skipped a round")
        log(f"{CHAIN_ROUNDS} from_entries trees of 2^{levels} entries {trees.seconds:.3f} s, "
            f"{CHAIN_ROUNDS} step proofs k={k} {proofs.seconds:.3f} s: "
            f"{CHAIN_ROUNDS * 60 / proofs.seconds:.3f} step proofs per minute ({card})")
    with Phase("incremental criterion: verify_chain, verify_chain_compressed, rejections"):
        chain_checks(art, chain, "criterion chain")
    with Phase("incremental criterion: final states from the rounds' roots and leaf hashes"):
        hashed_user = int.from_bytes(digests[CHAIN_USER].tobytes(), "big")
        user_state = liab_state = 0
        for balances in rounds:
            root = build_device_tree(digests, balances, device).root()
            leaf = poseidon.hash_n([hashed_user] + [int(b) for b in balances[CHAIN_USER]])
            user_state = poseidon.hash_n([user_state, leaf])
            liab_state = poseidon.hash_n([liab_state, root[0]])
        require(user_state == chain.user_states[-1] and liab_state == chain.liab_states[-1],
                "the chain's final states differ from the host's")
        log(f"final states {hex(user_state)}, {hex(liab_state)} == the host's from "
            f"{CHAIN_ROUNDS} roots (build_device_tree) and leaf hashes")
    return art


def incremental_byte_gate(device, art) -> None:
    """The criterion width against fixture (c): three synthetic rounds
    (``synthetic_merkle_proof(20, 1, ..., seed=s)``) chained from (0, 0),
    their step proofs at k=13 (on ``art``, the criterion chain's key) and
    the chained proof at k=14 equal to the JAX package's bytes; all verify,
    the chained one against the rounds' roots and leaf hashes."""
    from circuits_halo2_tpu_torch.merkle.mst import Entry, synthetic_merkle_proof
    from circuits_halo2_tpu_torch.models import incremental as INC
    from circuits_halo2_tpu_torch.ops import poseidon
    from circuits_halo2_tpu_torch.utils import pipeline

    fix = json.loads(INCREMENTAL_FIXTURE.read_text()).get("criterion")
    if fix is None:
        log("SKIPPED: the incremental criterion-width byte gate (the fixture has no part c)")
        return
    levels, ncur, nbytes = fix["levels"], fix["n_currencies"], fix["n_bytes"]
    witnesses = [synthetic_merkle_proof(levels, ncur, Entry(fix["user"], fix["balances"]), seed=s)
                 for s in fix["seeds"]]
    require((levels, ncur, nbytes, fix["step_k"]) == CRITERION,
            "fixture (c) is not at the criterion width")
    with Phase(f"incremental byte gate: {len(witnesses)} step proofs k={fix['step_k']}"):
        user_states, liab_states, steps = [0], [0], []
        for i, mp in enumerate(witnesses):
            circuit = INC.IncrementalMstInclusionCircuit.init_step(
                levels, ncur, nbytes, mp, user_states[-1], liab_states[-1])
            inst = circuit.instances()
            require(_hex_rows(inst) == fix["step_instances"][i], f"step {i + 1} instances differ")
            proof = pipeline.full_prover(art, circuit, inst)
            _require_hex(proof.hex(), fix["step_proofs"][i], f"criterion step {i + 1} proof")
            steps.append(INC.IncrementalStep(proof, inst))
            user_states.append(inst[0][2])
            liab_states.append(inst[0][3])
        require(INC.verify_chain(art, INC.IncrementalChainProof(steps, user_states, liab_states)),
                "the synthetic step chain does not verify")
        log(f"{len(steps)} step proofs == JAX fixture; the chain verifies")
    with Phase(f"incremental byte gate: chained SNARK k={fix['chain_k']} (setup + keygen, prove)"):
        cart = pipeline.generate_chained_artifacts(fix["chain_k"], None, levels, ncur, nbytes,
                                                   nsteps=len(witnesses), device=device)
        circuit = INC.ChainedMstInclusionCircuit.init_chain(levels, ncur, nbytes, witnesses)
        inst = circuit.instances()
        require(_hex_rows(inst) == fix["chain_instances"], "chained instances differ")
        proof = pipeline.full_prover(cart, circuit, inst)
        _require_hex(proof.hex(), fix["chain_proof"], f"criterion chained SNARK k={fix['chain_k']}")
    with Phase("incremental byte gate: verify_chain_snark"):
        roots = [mp.root.hash for mp in witnesses]
        leaves = [poseidon.hash_n([mp.entry.hashed_username] + mp.entry.balances)
                  for mp in witnesses]
        require([hex(v) for v in roots] == fix["roots"]
                and [hex(v) for v in leaves] == fix["leaf_hashes"],
                "synthetic roots or leaf hashes differ from the JAX package's")
        require(INC.verify_chain_snark(cart, proof, inst, roots, leaves),
                "verify_chain_snark rejects the criterion chained SNARK")
        require(not INC.verify_chain_snark(cart, proof, inst, roots[:2]),
                "verify_chain_snark accepts a truncated root list")
        log(f"chained SNARK k={fix['chain_k']} {len(proof)} B == JAX fixture, verifies against "
            "the synthetic roots and leaf hashes")


def incremental(device, card, digests) -> None:
    incremental_parity(device)
    incremental_byte_gate(device, incremental_criterion(device, card, digests))


def parallel_rank(mesh, leaves: str, root: str, sums: list, fixed: list,
                  permutation: list) -> dict:
    """One rank of the parallel path's gloo world (``parallel/worker``): the
    criterion's 2^20 leaves hashed and reduced over the mesh (K1), keygen
    and the Keccak proof of the JAX package's synthetic criterion witness
    with the mesh set (K3 on the rank's block of every MSM); the root, the
    VK and the proof bytes must equal the single-device ones."""
    from circuits_halo2_tpu_torch.merkle.device_tree import digests_to_limbs16, u64_to_limbs16
    from circuits_halo2_tpu_torch.merkle.mst import Entry, synthetic_merkle_proof
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.parallel import auto, sharding
    from circuits_halo2_tpu_torch.utils import pipeline
    from circuits_halo2_tpu_torch.utils.transcript import KeccakTranscript

    levels, ncur, nbytes, k = CRITERION
    require(mesh.backend == "gloo" and mesh.size == PARALLEL_RANKS, f"not a gloo mesh: {mesh}")
    name, dev, seconds = f"rank {mesh.rank}", mesh.device, {}
    data = np.load(leaves)
    t0 = time.perf_counter()
    user = FT.to_mont(torch.as_tensor(digests_to_limbs16(data["digests"]), device=dev))
    bal = FT.to_mont(torch.as_tensor(np.stack([u64_to_limbs16(data["balances"][:, c])
                                               for c in range(ncur)], axis=1), device=dev))
    leaf_hashes = sharding.sharded_hash_batch(mesh, torch.cat([user[None], bal.movedim(1, 0)]))
    root_h, root_b = sharding.sharded_tree_reduce(mesh, leaf_hashes, bal)
    got = [hex(FT.from_mont_ints(root_h)[0]), [FT.from_mont_ints(root_b[:, c])[0]
                                               for c in range(ncur)]]
    seconds["tree"] = time.perf_counter() - t0
    require(got == [root, sums], f"{name}: sharded root {got} != host root {[root, sums]}")

    auto.set_mesh(mesh)
    t0 = time.perf_counter()
    art = pipeline.generate_setup_artifacts(k, None, levels, ncur, nbytes, dev)
    seconds["keygen"] = time.perf_counter() - t0
    require([[hex(v) for v in pt] for pt in art.vk.fixed_commitments] == fixed
            and [[hex(v) for v in pt] for pt in art.vk.permutation_commitments] == permutation,
            f"{name}: the mesh VK differs from the single-device VK")
    fix = json.loads(CRITERION_FIXTURE.read_text())["criterion"]
    witness = synthetic_merkle_proof(fix["levels"], fix["n_currencies"],
                                     Entry(fix["user"], fix["balances"]), seed=fix["seed"])
    circuit = MstInclusionCircuit.init(levels, ncur, nbytes, witness)
    t0 = time.perf_counter()
    proof = pipeline.gen_proof_solidity_calldata(art, circuit).proof[2:]
    seconds["prove"] = time.perf_counter() - t0
    auto.clear_mesh()
    require(proof == fix["keccak_proof"], f"{name}: the mesh Keccak proof differs from the JAX "
            "package's: " + first_difference(proof, fix["keccak_proof"]))
    verify_and_flip(art, bytes.fromhex(proof), circuit.instances(), name, KeccakTranscript)
    return {"rank": mesh.rank, "k1": PK.hash_batch.launches, "k3": MK.segmented_scan.launches,
            "x0a": FT.mont_mul.launches, "x0b": FT.linear.launches,
            "x0c": FT.inv_mont.launches, "x1": NTT.ntt_passes.launches, "seconds": seconds,
            "sharded": mesh.sharded, "collectives": mesh.stats.calls,
            "collective_bytes": mesh.stats.nbytes, "collective_seconds": mesh.stats.seconds}


def nccl_rank(mesh) -> dict:
    """The rank of a 1-rank NCCL world: the sharded NTT of k=13's extended
    domain (2^15, a batch of 4) and the sharded commitment of 2^13 lanes
    (a batch of 3) equal the single-device results, their collectives
    through NCCL."""
    import torch.distributed as dist
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.parallel import msm_sharded, ntt_sharded
    from circuits_halo2_tpu_torch.utils.srs import setup_cached

    require(dist.get_backend() == "nccl" and mesh.backend == "nccl" and mesh.size == 1,
            f"not a 1-rank NCCL world: {dist.get_backend()}, {mesh}")
    rng = np.random.default_rng(SEED)
    dev = mesh.device

    def mont(shape):
        count = int(np.prod(shape[1:]))
        return torch.as_tensor(FT.to_mont_limbs(random_fr(rng, count)), device=dev).reshape(shape)

    a, omega = mont((16, 4, 1 << 15)), NTT.omega_for_k(15)
    t0 = time.perf_counter()
    got = ntt_sharded.ntt_sharded_batched(mesh, a, omega)
    torch.cuda.synchronize()
    seconds = {"ntt": time.perf_counter() - t0}
    require(torch.equal(got, NTT._ntt_device(a, omega)),
            "the sharded NTT over NCCL differs from the single-device NTT")
    xs, ys, valid = M.precompute_bases(setup_cached(13).g_lagrange, dev)
    scal = mont((16, 3, 1 << 13))
    before = MK.segmented_scan.launches
    t0 = time.perf_counter()
    acc = msm_sharded.commit_sharded_device(mesh, xs, ys, valid, scal)
    torch.cuda.synchronize()
    seconds["commit"] = time.perf_counter() - t0
    k3 = MK.segmented_scan.launches - before
    require(M._combine_windows_host(acc) == M._combine_windows_host(M._commit_dev(xs, ys, valid, scal)),
            "the sharded commitment over NCCL differs from the single-device one")
    require(mesh.stats.calls.get("all_to_all", 0) > 0 and mesh.stats.calls.get("all_gather", 0) > 0,
            f"collectives did not run: {mesh.stats.calls}")
    return {"k3": k3, "seconds": seconds, "collectives": mesh.stats.calls,
            "collective_bytes": mesh.stats.nbytes, "collective_seconds": mesh.stats.seconds}


def parallel(spawn, card, art, digests, balances, host_root) -> dict:
    """The mesh on the one card: a 4-rank gloo world (its collectives staged
    through host memory: NCCL refuses two ranks on one GPU) and a 1-rank
    NCCL world, each rank a child process of ``parallel/worker.launch``
    started by ``spawn``. Returns the gloo ranks' K1, K3, X0 and X1 launches
    (and the NCCL rank's K3)."""
    from circuits_halo2_tpu_torch import build
    from circuits_halo2_tpu_torch.parallel import worker

    leaves = build.build_dir() / "parallel_leaves.npz"
    np.savez(leaves, digests=digests, balances=balances)
    args = {"leaves": str(leaves), "root": hex(host_root[0]), "sums": host_root[1],
            "fixed": [[hex(v) for v in pt] for pt in art.vk.fixed_commitments],
            "permutation": [[hex(v) for v in pt] for pt in art.vk.permutation_commitments]}
    me = str(Path(__file__).resolve())
    with Phase(f"parallel: {PARALLEL_RANKS} gloo ranks on one card (2^20 tree, keygen and "
               "Keccak prove k=13 under the mesh)"):
        log(f"parallel: gloo asked for explicitly, collectives staged through host memory "
            f"(NCCL refuses two ranks on one GPU) ({card})")
        ranks = worker.launch(PARALLEL_RANKS, "gloo", "cuda", f"{me}:parallel_rank", args,
                              timeout=900, popen=spawn)
        for r in ranks:
            require(r["k1"] > 0 and r["k3"] > 0, f"rank {r['rank']}: K1 or K3 never launched")
            log(f"  rank {r['rank']}: tree {r['seconds']['tree']:.3f} s, keygen "
                f"{r['seconds']['keygen']:.3f} s, prove {r['seconds']['prove']:.3f} s; K1 {r['k1']}, "
                f"K3 {r['k3']}; sharded {r['sharded']}; collectives {r['collectives']}, "
                f"{r['collective_bytes']} B, {r['collective_seconds']:.3f} s")
        log(f"{PARALLEL_RANKS} ranks: the 2^20 sharded root == host root, the mesh VK == the "
            "single-device VK, the mesh Keccak proof == JAX fixture on every rank, verifies, "
            f"flipped byte rejected ({card})")
    with Phase("parallel: 1 NCCL rank (sharded NTT 2^15 x 4, commitment 2^13 x 3)"):
        nccl = worker.launch(1, "nccl", "cuda", f"{me}:nccl_rank", timeout=300, popen=spawn)[0]
        log(f"  NCCL rank: NTT {nccl['seconds']['ntt']:.3f} s, commit "
            f"{nccl['seconds']['commit']:.3f} s, K3 {nccl['k3']}; collectives "
            f"{nccl['collectives']}, {nccl['collective_bytes']} B, "
            f"{nccl['collective_seconds']:.3f} s ({card})")
        log("NCCL rank: the sharded NTT and commitment == single-device results")
    return {"k1": sum(r["k1"] for r in ranks), "k3": sum(r["k3"] for r in ranks) + nccl["k3"],
            **{key: sum(r[key] for r in ranks) for key in X0_X1}}


def entry16(device):
    """entry_16 at k=11 with the hermez-raw-11 SRS: byte-equal to the JAX proofs."""
    from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.utils import pipeline

    fix = json.loads((TESTS / "fixtures_torch_proofs.json").read_text())
    vk_fix = json.loads((TESTS / "fixtures_vk_inclusion.json").read_text())
    with Phase("entry_16 tree + setup + keygen k=11"):
        tree = MerkleSumTree.from_csv(str(TESTS / fix["csv"]), device)
        art = pipeline.generate_setup_artifacts(
            fix["k"], str(TESTS / "fixtures_ptau_hermez-raw-11"), fix["levels"],
            fix["n_currencies"], fix["n_bytes"], device)
        fixed = [(int(x, 16), int(y, 16)) for x, y in vk_fix["fixed_comms"]]
        perm = [(int(x, 16), int(y, 16)) for x, y in vk_fix["permutation_comms"]]
        if art.vk.fixed_commitments != fixed or art.vk.permutation_commitments != perm:
            raise AssertionError("k=11 VK commitments differ from fixtures_vk_inclusion.json")
        log("11 fixed + 6 permutation commitments == fixtures_vk_inclusion.json")
    circuit = MstInclusionCircuit.init(fix["levels"], fix["n_currencies"], fix["n_bytes"],
                                       tree.generate_proof(fix["user_index"]))
    instances = circuit.instances()
    if [[hex(v) for v in col] for col in instances] != fix["instances"]:
        raise AssertionError("entry_16 instances differ from the fixture")
    with Phase("entry_16 Keccak proof (gen_proof_solidity_calldata)"):
        calldata = pipeline.gen_proof_solidity_calldata(art, circuit,
                                                        vk_digest=int(vk_fix["vk_digest"], 16))
        if calldata.proof[2:] != fix["keccak_vk_digest_proof"]:
            raise AssertionError("Keccak proof differs from the JAX package's")
        log(f"Keccak proof {len(calldata.proof) // 2 - 1} B == JAX fixture")
    with Phase("entry_16 Blake2b proof (full_prover)"):
        proof = pipeline.full_prover(art, circuit, instances)
        if proof.hex() != fix["blake2b_proof"] or not pipeline.full_verifier(art, proof, instances):
            raise AssertionError("Blake2b proof differs from the JAX package's or fails")
        log(f"Blake2b proof {len(proof)} B == JAX fixture, verifies")


def ceremony_downsize(device):
    """The hermez-raw-11 ceremony file downsized to k=10 through X4: the
    Lagrange bases hash to the JAX package's (fixture "downsize")."""
    from circuits_halo2_tpu_torch.ops import curve as C
    from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

    fix = json.loads(CRITERION_FIXTURE.read_text())["downsize"]
    with Phase("hermez-raw-11 downsized to k=10 through X4"):
        params = ParamsKZG.read(str(TESTS / fix["ptau"])).downsize(fix["k"], device)
        raw = b"".join(C.g1_to_raw_bytes(p) for p in params.g_lagrange)
        require(len(params.g_lagrange) == fix["count"]
                and hashlib.sha256(raw).hexdigest() == fix["g_lagrange_sha256"],
                "downsized hermez-raw-11 Lagrange bases differ from the JAX package's")
        log(f"hermez-raw-11 -> k={fix['k']}: {fix['count']} Lagrange bases, sha256 == JAX fixture")


def full_width_downsize(device, rng, circuit):
    """The north-star SRS (2^17 points) downsized to the criterion's 2^13
    through X4 by ``generate_setup_artifacts``: the monomial bases are its
    first 2^13, sum_i L_i(s) = 1 gives sum g_lagrange = G, a polynomial
    commits alike in both bases; then a criterion proof with these
    artifacts verifies."""
    from circuits_halo2_tpu_torch import native
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.utils import pipeline
    from circuits_halo2_tpu_torch.utils.srs import cached_path, setup_cached

    levels, ncur, nbytes, k = CRITERION
    n = 1 << k
    with Phase("north-star SRS setup_cached(17)"):
        big = setup_cached(NORTHSTAR[3])
    with Phase("generate_setup_artifacts(13, 2^17 SRS file): downsize through X4 + keygen"):
        art = pipeline.generate_setup_artifacts(k, str(cached_path(NORTHSTAR[3])), levels, ncur,
                                                nbytes, device)
    with Phase("downsized bases: three identities"):
        g, lagrange = art.params.g, art.params.g_lagrange
        require(g == big.g[:n], "downsize changed the first 2^13 monomial bases")
        require(native.g1_msm(lagrange, [1] * n) == G1_GEN, "sum of the Lagrange bases != G")
        coeffs = random_fr(rng, n)
        require(native.g1_msm(g, coeffs)
                == native.g1_msm(lagrange, NTT.ntt_host(coeffs, NTT.omega_for_k(k))),
                "a polynomial commits differently in the downsized Lagrange bases")
        log("2^17 -> 2^13: g unchanged, sum g_lagrange == G, commit(c) == commit_lagrange(ntt(c))")
    with Phase("criterion prove + verify k=13 with the downsized SRS"):
        instances = circuit.instances()
        verify_and_flip(art, pipeline.full_prover(art, circuit, instances), instances,
                        "criterion (downsized SRS)")


def northstar(device):
    """North-star config: 2^16 entries, 2 currencies, N_BYTES=8, LEVELS=16,
    k=17, seed-0 data (bench_suite.py:286-292)."""
    from circuits_halo2_tpu_torch.merkle.device_tree import build_device_tree
    from circuits_halo2_tpu_torch.merkle.mst import Entry
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.utils import pipeline

    levels, ncur, nbytes, k = NORTHSTAR
    n = 1 << levels
    entry0 = Entry(USER, [11888, 41163])
    rng = np.random.default_rng(SEED)
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    digests[0] = np.frombuffer(entry0.hashed_username.to_bytes(32, "big"), dtype=np.uint8)
    balances = rng.integers(0, 1 << 48, size=(n, ncur), dtype=np.uint64)
    balances[0] = entry0.balances

    with Phase("north-star tree 2^16 x 2 currencies on device (K1)"):
        tree = build_device_tree(digests, balances, device)
        root = tree.root()
    with Phase("north-star tree host reference"):
        host_root = host_tree_root(digests, balances)
        require(root == host_root, f"north-star root {root} != host root {host_root}")
        log(f"north-star root {hex(root[0])} balances {root[1]} == host")
    with Phase("north-star setup + keygen k=17"):
        art = pipeline.generate_setup_artifacts(k, None, levels, ncur, nbytes, device)
    with Phase("north-star prove k=17 (full_prover, Blake2b)"):
        circuit = MstInclusionCircuit.init(levels, ncur, nbytes, tree.generate_proof(0, entry0))
        instances = circuit.instances()
        proof = pipeline.full_prover(art, circuit, instances)
    with Phase("north-star verify k=17"):
        verify_and_flip(art, proof, instances, "north-star")
    fix = json.loads(CRITERION_FIXTURE.read_text()).get("northstar")
    if fix is None:
        log("north-star byte comparison skipped: the fixture has no north-star proofs")
    else:
        synthetic_proofs(art, fix, "north-star")


BENCH_STAGES = "build,msm,ntt,keygen,prove,verify"  # the quick stages; the full run is separate
BENCH_METRICS = ("mst_build_2^16", "mst_build_sorted_2^16", "msm_pippenger_2^13x4", "ntt_2^15",
                 "keygen_vk_pk_k11", "prove_mst_inclusion_k11", "verify_mst_inclusion_k11")


BENCH_SUITE = ("circuits_halo2_tpu_torch.bench_suite",
               {"BENCH_STAGES": BENCH_STAGES, "BENCH_REPEATS": "1"}, BENCH_METRICS)
BENCH_HEADLINE = ("circuits_halo2_tpu_torch.bench", {}, ("poseidon_bn254_hashes_per_sec",))


def start_bench_suite(spawn):
    """Start ``bench_suite`` at its quick stages with one warm repeat
    (default sizes: the 2^16 tree, MSM 2^13 x 4, NTT 2^15, and keygen,
    prove and verify at k=11, whose Blake2b proof must equal the JAX
    package's bytes) in a child process, its output to a file. It runs
    beside the incremental path, which is host-bound, so its times are not
    measurements (the full run is separate); ``bench`` joins it."""
    import os

    from circuits_halo2_tpu_torch import build

    module, env, _ = BENCH_SUITE
    out = build.build_dir() / "bench_suite.log"
    with out.open("w") as f:
        proc = spawn([sys.executable, "-m", module], env=os.environ | env, stdout=f)
    return proc, out


def bench(spawn, card, suite) -> dict:
    """The port's bench entry points: joins ``suite`` (``start_bench_suite``),
    then runs the headline ``bench`` at its default batch in a child process
    started by ``spawn``. Each must exit 0 (every gate held) and print its
    metrics; the prove line must carry its profile. Returns the K1 and K3
    launches of their lines."""
    import os

    lines = []
    for (module, env, metrics), started in ((BENCH_SUITE, suite), (BENCH_HEADLINE, None)):
        flags = " ".join(f"{key}={value}" for key, value in env.items())
        how = "started before the incremental path; waiting for it" if started else "child process"
        with Phase(f"bench: {f'{flags} ' if flags else ''}python -m {module} ({how})"):
            if started:
                proc, path = started
                proc.wait(timeout=900)
                out = path.read_text().splitlines()
            else:
                proc = spawn([sys.executable, "-m", module], env=os.environ | env)
                out = proc.communicate(timeout=600)[0].splitlines()
            got = [json.loads(line) for line in out if line.startswith('{"metric"')]
            for line in out:
                if not line.startswith('{"metric"'):
                    log(f"  {module}: {line}")
            for line in got:
                log(json.dumps(line))
            require(proc.returncode == 0, f"{module} exited with {proc.returncode}")
            missing = set(metrics) - {line["metric"] for line in got}
            require(not missing, f"{module} printed no line for {sorted(missing)}")
            lines += got
    by_metric = {line["metric"]: line for line in lines}
    require(by_metric["verify_mst_inclusion_k11"]["ok"] is True, "the bench's k=11 proof failed")
    prove = by_metric["prove_mst_inclusion_k11"]
    require("idle_share" in prove or prove.get("profiler") == "no device events",
            "the bench's prove line has no profile")
    hand = ", ".join(f"{h['kernel']} {h['launches']} ({h['device_s'] * 1e3:.3f} ms)"
                     for h in prove.get("hand_kernels", []) if h["launches"])
    log(f"bench: every gate held; k=11 prove {prove['value']:.3f} s (traced "
        f"{prove['traced_s']:.3f} s; beside the incremental path), idle share "
        f"{prove.get('idle_share')}, {prove.get('launches')} CUDA kernels (hand kernels: "
        f"{hand or 'none'}); headline "
        f"{by_metric['poseidon_bn254_hashes_per_sec']['value']:.1f} hashes/s ({card})")
    return {"k1": sum(line["k1_launches"] for line in lines),
            "k3": sum(line["k3_launches"] for line in lines)}


def timings(device, rng, card, probes, report):
    """Kernel vs plain torch at the paths' shapes (CUDA events, mean of 5
    warm launches, X4 of 3; plain torch one launch), each with its bound."""
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field as F
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
    from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP
    from circuits_halo2_tpu_torch.utils import ec_fft as EC
    from circuits_halo2_tpu_torch.utils.srs import ParamsKZG, setup_cached

    out = {}
    n = 1 << 20
    for length in (2, 3):  # leaf and middle levels of the 1-currency tree
        raw = torch.stack([torch.as_tensor(FT.ints_to_limbs(random_fr(rng, n)), device=device)
                           for _ in range(length)])
        mont = FT.to_mont(raw.movedim(1, 0)).movedim(0, 1).contiguous()
        k1 = cuda_ms(lambda: PK.hash_batch(mont), 5)
        k4 = cuda_ms(lambda: PM.hash_batch_mxu(raw), 5)
        out[f"k1_L{length}"] = [k1, None, *bound_ms(n * length * PERM_WIDE,
                                                     0, n * (length + 1) * FE)]
        wide, tensor = PM.ops_per_hash(length)
        out[f"k4_L{length}"] = [k4, None, *bound_ms(n * wide, n * tensor, n * (length + 1) * FE)]
        if length == 2:
            out["k1_L2"][1] = cuda_ms(lambda: PK.hash_batch_ref(mont), 1, warm=False)
            out["k4_L2"][1] = cuda_ms(lambda: PM.hash_batch_mxu_ref(raw), 1, warm=False)
            a, b = mont[0], mont[1]
            k2 = cuda_ms(lambda: PK.permute(a, b), 5)
            k2_plain = cuda_ms(lambda: PK.permute_ref(a, b), 1, warm=False)
            out["k2"] = [k2, k2_plain, *bound_ms(n * PERM_WIDE, 0, n * 4 * FE)]
            log(f"K2 2^20: kernel {k2:.3f} ms, plain torch {k2_plain:.3f} ms, "
                f"bound {out['k2'][2]:.3f} ms ({card})")
        log(f"2^20 L={length}: K1 {k1:.3f} ms (bound {out[f'k1_L{length}'][2]:.3f}), "
            f"K4 {k4:.3f} ms (bound {out[f'k4_L{length}'][2]:.3f}) on the same messages ({card})")
    log(f"plain torch 2^20 L=2: K1 {out['k1_L2'][1]:.3f} ms, K4 {out['k4_L2'][1]:.3f} ms")

    params = setup_cached(13)
    xs, ys, valid = M.precompute_bases(params.g_lagrange, device)
    for batch in (3, 16):  # a prover commitment batch; keygen's largest batch
        scal = torch.as_tensor(FT.to_mont_limbs(random_fr(rng, batch << 13))
                               .reshape(16, batch, 1 << 13), device=device)
        px, py, pv, seg, L = sorted_scan_inputs(xs, ys, valid, scal)
        k_ms = cuda_ms(lambda: MK.segmented_scan(px, py, pv, seg, L), 5)
        p_ms = None
        if batch == 3:
            p_ms = cuda_ms(lambda: MK.segmented_scan_ref(px, py, pv, seg, L), 1, warm=False)
        key = "k3" if batch == 3 else f"k3_b{batch}"
        out[key] = [k_ms, p_ms, *k3_bound(pv, seg, L)]
        plain = f", plain torch {p_ms:.3f} ms" if p_ms is not None else ""
        wide, nbytes = k3_work(pv, seg, L)
        log(f"K3 k=13 commit batch {batch} (lanes {px[0].numel() // L}, L={L}): kernel "
            f"{k_ms:.4f} ms{plain}, bound {out[key][2]:.4f} ms ({out[key][3]}; operations "
            f"{bound_ms(wide)[0]:.4f} ms, bytes of the int64-limb layout "
            f"{bound_ms(0, 0, nbytes)[0]:.4f} ms) ({card})")

    x, y = EXP.make_inputs("mxu_mul", EXP.LANES, 3, device)
    wide, tensor = EXP.ops_per_iter("mxu_mul")
    work = EXP.LANES * EXP.ITERS_LO
    out["k5"] = [cuda_ms(lambda: EXP.run("mxu_mul", x, y, EXP.ITERS_LO), 5),
                 cuda_ms(lambda: EXP.run_ref("mxu_mul", x, y, EXP.ITERS_LO), 1, warm=False),
                 *bound_ms(work * wide, work * tensor, EXP.LANES * 3 * FE)]
    for r in probes:
        if r["variant"] != "check":
            wide, tensor = EXP.ops_per_iter(r["variant"])
            per_iter_ns = bound_ms(wide, tensor)[0] * 1e6
            log(f"K5 {r['variant']}: {r['ns_per_elem_iter']:.5f} ns per element-iteration, "
                f"bound {per_iter_ns:.5f} ns ({card})")
    x, y = EXP.make_inputs("mxu_mul", 8 * 128, 2, device)
    wide, tensor = EXP.ops_per_iter("mxu_mul")
    out["k6"] = [cuda_ms(lambda: EXP.mxu_mul_once(x, y), 5),
                 cuda_ms(lambda: EXP.PM.mul_ref(x, y), 1, warm=False),
                 *bound_ms(8 * 128 * wide, 8 * 128 * tensor, 8 * 128 * 3 * FE)]

    n = 1 << 13  # the 2^17 -> 2^13 downsize (its first 2^13 points; setup(13)'s are alike)
    transforms = [(F.fr_inv(NTT.omega_for_k(13)), F.fr_inv(n))]
    args = EC.transform_inputs(params.g, transforms, device)
    ms = cuda_ms(lambda: EK.ec_fft(*args), 3)
    bound, by = x4_glv_bound(n, transforms)
    log(f"X4 scaled inverse EC-FFT n=2^13 (14 launches): {ms:.3f} ms, bound {bound:.3f} ms "
        f"({by}; the reference's double-and-add {x4_bound(n, transforms)[0]:.3f} ms) ({card})")
    # the 2^10 kernel again here, on a quiet card (its child timed it beside
    # the other checks); the plain time is the child's
    n = 1 << 10
    transforms = [(F.fr_inv(NTT.omega_for_k(10)), F.fr_inv(n))]
    ceremony = ParamsKZG.read(str(TESTS / "fixtures_ptau_hermez-raw-11"))
    args = EC.transform_inputs(ceremony.g[:n], transforms, device)
    out["x4"] = [cuda_ms(lambda: EK.ec_fft(*args), 3), *report["x4"][1:4]]
    log(f"X4 scaled inverse EC-FFT n=2^10 (11 launches): {out['x4'][0]:.3f} ms "
        f"({report['x4'][0]:.3f} beside the other checks), plain torch {out['x4'][1]:.1f} ms, "
        f"bound {out['x4'][2]:.4f} ms (the reference's double-and-add {report['x4'][4]:.4f} "
        f"ms) ({card})")
    big = report["x4_big"]
    log(f"X4 scaled inverse EC-FFT n=2^{X4_BIG} ({X4_BIG + 1} launches): {big[0]:.3f} ms, bound "
        f"{big[1]:.3f} ms (the reference's double-and-add {big[3]:.3f} ms) ({card})")
    return out


def lost_time(device, digests, balances, circuit, card):
    """Time and bound summed over every launch of K1, K3 and K4 on a repeat
    of their paths -- the 2^20 tree through K1 and through K4, keygen and
    one prove at k=13 -- apart from the timed phases. The three wrappers
    are wrapped for the repeat: each call is fenced by CUDA events (so its
    time is the wrapper's on the stream, any layout conversion included)
    and its bound is taken from its shape and, for K3, its digits. Also
    logs the share of the first tree's K1 time spent on its 14 smallest
    levels (2^13 messages or fewer)."""
    from circuits_halo2_tpu_torch.merkle import device_tree as DT
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
    from circuits_halo2_tpu_torch.utils import pipeline

    bound = {"k1": 0.0, "k3": 0.0, "k4": 0.0}
    spans = {"k1": [], "k3": [], "k4": []}

    small = []  # K1 launches on the 14 smallest tree levels (2^13 messages or fewer)

    def timed(key, fn, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        spans[key].append((start, end))
        return out

    def k1(inputs):
        length, _, n = inputs.shape
        bound["k1"] += bound_ms(n * length * PERM_WIDE, 0, n * (length + 1) * FE)[0]
        if n <= 1 << 13:
            small.append(len(spans["k1"]))
        return timed("k1", hash_batch, inputs)

    def k3(px, py, pvalid, seg, L):
        bound["k3"] += k3_bound(pvalid, seg, L)[0]
        return timed("k3", segmented_scan, px, py, pvalid, seg, L)

    def k4(inputs):
        length, _, n = inputs.shape
        wide, tensor = PM.ops_per_hash(length)
        bound["k4"] += bound_ms(n * wide, n * tensor, n * (length + 1) * FE)[0]
        return timed("k4", hash_batch_mxu, inputs)

    hash_batch, segmented_scan, hash_batch_mxu = PK.hash_batch, MK.segmented_scan, PM.hash_batch_mxu
    k1.launches = k3.launches = k4.launches = 0  # each wrapper counts on its module's name
    PK.hash_batch, MK.segmented_scan, PM.hash_batch_mxu = k1, k3, k4
    try:
        DT.build_device_tree(digests, balances, device)
        DT.tree_root_mxu(digests, balances, device)
        levels, ncur, nbytes, k = CRITERION
        art = pipeline.generate_setup_artifacts(k, None, levels, ncur, nbytes, device)
        pipeline.full_prover(art, circuit, circuit.instances())
        torch.cuda.synchronize()
    finally:
        PK.hash_batch, MK.segmented_scan, PM.hash_batch_mxu = hash_batch, segmented_scan, hash_batch_mxu
    for key in ("k1", "k3", "k4"):
        ms = sum(start.elapsed_time(end) for start, end in spans[key])
        log(f"{key.upper()} on its path: {len(spans[key])} launches, {ms:.3f} ms, "
            f"bound {bound[key]:.3f} ms, lost {ms - bound[key]:.3f} ms ({card})")
    tree = spans["k1"][:21]  # the first 2^20 tree: 21 levels, leaves first
    small_ms = sum(s.elapsed_time(e) for i, (s, e) in enumerate(tree) if i in small)
    log(f"K1 levels of 2^13 messages or fewer: {sum(i < 21 for i in small)} launches, "
        f"{small_ms:.3f} ms of the tree's {sum(s.elapsed_time(e) for s, e in tree):.3f} ms ({card})")


KERNELS = (  # key, name, source, replaced TPU kernel
    ("k1", "poseidon_sponge", "csrc/poseidon.cu", "ops/poseidon_pallas2.py:310"),
    ("k2", "poseidon_permute", "csrc/poseidon.cu", "ops/poseidon_pallas2.py:246"),
    ("k3", "msm_bucket_scan", "csrc/msm_scan.cu", "ops/msm_pallas.py:438"),
    ("k4", "poseidon_sponge_mxu", "csrc/poseidon_mxu.cu", "ops/poseidon_mxu.py:202"),
    ("k5", "poseidon_mxu_probe", "csrc/poseidon_mxu.cu", "scripts/exp_poseidon_mxu.py:180"),
    ("k6", "poseidon_mxu_check", "csrc/poseidon_mxu.cu", "scripts/exp_poseidon_mxu.py:224"),
    ("x4", "ec_fft", "csrc/ec_fft.cu", "circuits_halo2_tpu/utils/ec_fft.py:181 (XLA, no Pallas)"),
    ("x0a", "field_mont_mul", "csrc/field_ops.cu",
     "circuits_halo2_tpu/ops/field_jax.py:329 (XLA, no Pallas)"),
    ("x0b", "field_add_sub_neg", "csrc/field_ops.cu",
     "circuits_halo2_tpu/ops/field_jax.py:352 (XLA, no Pallas)"),
    ("x0c", "field_inv_divstep", "csrc/field_ops.cu",
     "circuits_halo2_tpu/ops/field_jax.py:413 (XLA, no Pallas)"),
    ("x0c_pow", "field_pow", "csrc/field_ops.cu",
     "circuits_halo2_tpu/ops/field_jax.py:397 (XLA, no Pallas)"),
    ("x1", "ntt_passes", "csrc/ntt.cu", "circuits_halo2_tpu/ops/ntt.py:177 (XLA, no Pallas)"),
)
X0_X1 = ("x0a", "x0b", "x0c", "x1")  # the kernels of every proving path (not the power chain)


X4_CHILDREN = {  # argument of a child process: its X4 check
    "--x4-ceremony": x4_ceremony,
    "--x4-full-width": lambda device: {"x4_err": x4_full_width(device)},
}


def main() -> int:
    """The run, with every child process it starts stopped when it ends."""
    if len(sys.argv) == 2 and sys.argv[1] in X4_CHILDREN:
        print(json.dumps(X4_CHILDREN[sys.argv[1]](torch.device("cuda", 0))), flush=True)
        return 0
    children: list[subprocess.Popen] = []

    def spawn(args: list[str], **kwargs) -> subprocess.Popen:
        kwargs = {"cwd": ROOT, "stdout": subprocess.PIPE, "stderr": subprocess.STDOUT,
                  "text": True} | kwargs
        children.append(subprocess.Popen(args, **kwargs))
        return children[-1]

    try:
        return run(spawn)
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run(spawn) -> int:
    """The smoke run; ``spawn`` starts a child process, which ``main`` stops
    at the end."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from circuits_halo2_tpu_torch import build
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
    from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP

    with Phase("kernel build (nvcc sm_90a)"):
        lib, seconds, ptxas = build.compile_cuda()
        build.cuda_library()
        log(f"built {lib.name} in {seconds:.1f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    # the recursion example (its k=11 chain on the card, NIFS and Spartan on
    # the host) runs beside everything else and is joined after the
    # incremental path
    example_t0 = time.perf_counter()
    example = spawn([sys.executable, "-m", EXAMPLE,
                     "--out", str(build.build_dir() / "example_out")])
    # X4's plain version is minutes of launch-bound torch at each of the
    # main path's shapes: a child process checks each while this one checks
    # the other kernels
    x4_children = {arg: spawn([sys.executable, str(Path(__file__).resolve()), arg])
                   for arg in X4_CHILDREN}
    rng = np.random.default_rng(SEED)
    report: dict = {}
    with Phase("K1 vs plain"):
        check_k1(device, rng, report)
    with Phase("K3 vs plain"):
        check_k3(device, rng, report)
    with Phase("K2 vs plain"):
        check_k2(device, rng, report)
    with Phase("K4 vs plain and K1"):
        check_k4(device, rng, report)
    with Phase("K5, K6 vs plain"):
        check_k5_k6(device, report)
    with Phase("X4 vs plain and the host EC-FFT"):
        check_x4(device, rng, report)
    with Phase("X0a-X0c, X1 vs plain"):
        check_x0_x1(device, report)
    with Phase(f"X4 at n=2^{X4_BIG} vs the analytic Lagrange bases"):
        x4_analytic(device, report)
    with Phase("X4 vs plain at n=2^10 and 2^13 (child processes; waiting for them)"):
        for arg, proc in x4_children.items():
            out = proc.communicate(timeout=1200)[0].strip().splitlines()
            for line in out:
                log(f"  {arg}: {line}")
            require(proc.returncode == 0 and out, f"the X4 check {arg} failed in its child")
            got = json.loads(out[-1])
            report["x4_err"] = max(report["x4_err"], got["x4_err"])
            report.update({key: got[key] for key in ("x4",) if key in got})
        log("X4 n=2^10 (hermez-raw-11, scaled inverse) and n=2^13 (setup(13), scaled "
            f"inverse): equal to plain torch; at 2^10 kernel {report['x4'][0]:.3f} ms, "
            f"plain torch {report['x4'][1]:.1f} ms, bound {report['x4'][2]:.4f} ms "
            f"({report['x4'][3]})")

    wrappers = {"k1": PK.hash_batch, "k2": PK.permute, "k3": MK.segmented_scan,
                "k4": PM.hash_batch_mxu, "k5": EXP.run, "k6": EXP.mxu_mul_once, "x4": EK.ec_fft,
                "x0a": FT.mont_mul, "x0b": FT.linear, "x0c": FT.inv_mont, "x0c_pow": FT.mont_pow,
                "x1": NTT.ntt_passes}
    launches = {}
    for w in wrappers.values():
        w.launches = 0
    digests, balances, host_root, circuit, art, tree, entries, blake2b_0 = criterion(device)
    entry16(device)
    ceremony_downsize(device)
    full_width_downsize(device, rng, circuit)
    northstar(device)
    launches.update(k1=PK.hash_batch.launches, k3=MK.segmented_scan.launches,
                    x4=EK.ec_fft.launches, x0c_pow=FT.mont_pow.launches,
                    **{key: wrappers[key].launches for key in X0_X1})
    log("proving-path launches: " + ", ".join(f"{key.upper()} {launches[key]}"
                                              for key in ("k1", "k3", "x4", *X0_X1)))

    def counted(name, kernels, run):
        """Drive one more path with every count set to 0; its kernels must
        launch. ``run`` returns the launches of its child processes, if any."""
        for w in wrappers.values():
            w.launches = 0
        children = run() or {}
        counts = {key: w.launches + children.get(key, 0) for key, w in wrappers.items()}
        log(f"{name} launches: " + ", ".join(f"{key.upper()} {c}" for key, c in counts.items()))
        require(all(counts[key] for key in kernels), f"{name}: a kernel of its path never launched")
        for key in (*kernels, "x0c_pow"):
            launches[key] += counts[key]

    counted("batch-prover", ("k3", *X0_X1),
            lambda: batch_prover(device, art, tree, entries, blake2b_0, card))
    round_digests = []  # the round's username digests, which the incremental path reuses
    counted("operator-round", ("k1", "k3", *X0_X1),
            lambda: round_digests.append(operator_round(device, card)))
    # the bench's quick stages run beside the incremental path (host-bound)
    # and are joined at the bench path
    suite = start_bench_suite(spawn)
    counted("incremental", ("k1", "k3", *X0_X1),
            lambda: incremental(device, card, round_digests[0]))
    with Phase(f"example {EXAMPLE} (child process; waiting for it)"):
        out = example.communicate(timeout=900)[0].strip().splitlines()
        for line in out:
            log(f"  example: {line}")
        require(example.returncode == 0, f"the example exited with {example.returncode}")
        log(f"example exited 0; joined {time.perf_counter() - example_t0:.1f} s after it was "
            f"started ({card})")
    counted("parallel", ("k1", "k3", *X0_X1),
            lambda: parallel(spawn, card, art, digests, balances, host_root))
    counted("bench", ("k1", "k3"), lambda: bench(spawn, card, suite))

    for key in ("k2", "k4", "k5", "k6"):
        wrappers[key].launches = 0
    probes = poseidon_engine(device, digests, balances, host_root)
    launches.update({key: wrappers[key].launches for key in ("k2", "k4", "k5", "k6")})
    log(f"Poseidon engine launches: K2 {launches['k2']}, K4 {launches['k4']}, "
        f"K5 {launches['k5']}, K6 {launches['k6']}")
    # the power chain is on no path: only inv_mont called it, and the
    # inversion has its own kernel now; its count is reported as it is
    idle = [key for key, count in launches.items() if not count and key != "x0c_pow"]
    require(not idle, f"a kernel of its path never launched: {idle}")

    with Phase("kernel vs plain timings"):
        times = timings(device, rng, card, probes, report)
        times.update(x0_x1_timings(device, art, circuit, card))
    with Phase("repeat: time lost per kernel on its path"):
        lost_time(device, digests, balances, circuit, card)
    times["k1"], times["k4"] = times["k1_L2"], times["k4_L2"]

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": f"circuits_halo2_tpu_torch/{src}",
         "replaces": f"circuits_halo2_tpu/{tpu}" if tpu.startswith("ops") else tpu,
         "launches": launches[key], "max_abs_err": report[f"{key}_err"],
         "ms": times[key][0], "plain_ms": times[key][1], "bound_ms": times[key][2],
         "bound_by": times[key][3], "library_ms": None}
        for key, name, src, tpu in KERNELS
    ]}
    log(f"whole script {time.perf_counter() - t_start:.1f} s ({card})")
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
