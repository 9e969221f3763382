"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``circuits_halo2_tpu_torch/csrc``,
checks each of the six (K1-K6) against its plain torch version on the card,
then drives two paths through their user entry points, each with the launch
counts set to 0 just before it and read just after:

- the proving path at the reference criterion size (a 2^20-entry Merkle
  sum tree, N_CURRENCIES=1, N_BYTES=8, LEVELS=20, k=13) and at the
  entry_16 k=11 fixture, where the proofs must equal the JAX package's
  byte for byte (tests/fixtures_torch_proofs.json): K1 and K3;
- the Poseidon engine at the same width: the criterion tree's root built
  through the tensor-core sponge (K4) from raw digests and sums, equal to
  the host root; the bare permutation (K2) of the 2^20 leaf states; and
  the probe experiment (K5, with the K6 exactness check).

Prints one line per phase with its wall time, the kernels' JSON summary
(times, launches, bounds), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and no ``ok`` line is printed. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

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
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


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


def random_fr(rng: np.random.Generator, count: int) -> list[int]:
    from circuits_halo2_tpu_torch.ops.field_torch import FR

    raw = rng.integers(0, 256, size=(count, 32), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % FR.mod_int for r in raw]


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
    keygen batch of 16 columns at 2^13, and skewed digits (90 % zero
    scalars, 3 columns: bucket 0 spans whole chunks) at 2^13 and at 2^14,
    whose chunks are twice as long."""
    from circuits_halo2_tpu_torch import native
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK

    bases = {}
    for logn, batch, zeros in ((11, 4, 0.0), (13, 4, 0.0), (13, 16, 0.0), (13, 3, 0.9),
                                (14, 3, 0.9)):
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
    """Root of the 1-currency tree by the native host sponge."""
    from circuits_halo2_tpu_torch import native
    from circuits_halo2_tpu_torch.ops.field_torch import FR

    FR_MOD = FR.mod_int
    users = [int.from_bytes(d.tobytes(), "big") % FR_MOD for d in digests]
    sums = [int(b) for b in balances[:, 0]]
    hashes = native.poseidon_hash_batch(list(zip(users, sums)), 2)
    while len(hashes) > 1:
        sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
        hashes = native.poseidon_hash_batch(
            [(s % FR_MOD, hashes[2 * i], hashes[2 * i + 1]) for i, s in enumerate(sums)], 3)
    return hashes[0], [sums[0] % FR_MOD]


def criterion(device):
    """Reference criterion config: 2^20 entries, LEVELS=20, k=13."""
    from circuits_halo2_tpu_torch.merkle.device_tree import build_device_tree
    from circuits_halo2_tpu_torch.merkle.mst import Entry
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.utils import pipeline

    levels, ncur, nbytes, k = CRITERION
    n = 1 << levels
    entry0 = Entry("dxGaEAii", [11888])
    rng = np.random.default_rng(SEED)
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    digests[0] = np.frombuffer(entry0.hashed_username.to_bytes(32, "big"), dtype=np.uint8)
    balances = rng.integers(0, 1 << 40, size=(n, ncur), dtype=np.uint64)
    balances[0, 0] = entry0.balances[0]

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
        if not pipeline.full_verifier(art, proof, instances):
            raise AssertionError("criterion proof does not verify")
        bad = [list(instances[0])]
        bad[0][2] += 1
        if pipeline.full_verifier(art, proof, bad):
            raise AssertionError("criterion proof verifies against a flipped instance")
        log(f"criterion proof {len(proof)} B verifies; flipped instance rejected")
    return digests, balances, host_root, circuit


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


def timings(device, rng, card, probes):
    """Kernel vs plain torch at the paths' shapes (CUDA events, mean of 5
    warm launches; plain torch one launch), each with its bound."""
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
    from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP
    from circuits_halo2_tpu_torch.utils.srs import setup_cached

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
)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from circuits_halo2_tpu_torch import build
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
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

    wrappers = {"k1": PK.hash_batch, "k2": PK.permute, "k3": MK.segmented_scan,
                "k4": PM.hash_batch_mxu, "k5": EXP.run, "k6": EXP.mxu_mul_once}
    launches = {}
    for w in wrappers.values():
        w.launches = 0
    digests, balances, host_root, circuit = criterion(device)
    entry16(device)
    launches.update(k1=PK.hash_batch.launches, k3=MK.segmented_scan.launches)
    log(f"proving-path launches: K1 {launches['k1']}, K3 {launches['k3']}")

    for key in ("k2", "k4", "k5", "k6"):
        wrappers[key].launches = 0
    probes = poseidon_engine(device, digests, balances, host_root)
    launches.update({key: wrappers[key].launches for key in ("k2", "k4", "k5", "k6")})
    log(f"Poseidon engine launches: K2 {launches['k2']}, K4 {launches['k4']}, "
        f"K5 {launches['k5']}, K6 {launches['k6']}")
    idle = [key for key, count in launches.items() if not count]
    require(not idle, f"a kernel of its path never launched: {idle}")

    with Phase("kernel vs plain timings"):
        times = timings(device, rng, card, probes)
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
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
