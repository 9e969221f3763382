"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``circuits_halo2_tpu_torch/csrc``,
checks each against its plain torch version on the card, then drives the
port's main path through its user entry points at the reference criterion
size (a 2^20-entry Merkle sum tree, N_CURRENCIES=1, N_BYTES=8, LEVELS=20,
k=13) and at the entry_16 k=11 fixture, where the proofs must equal the
JAX package's byte for byte (tests/fixtures_torch_proofs.json). Prints one
line per phase with its wall time, the kernels' JSON summary, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Any
failure raises: the exit code is non-zero and no ``ok`` line is printed.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

# The port binds its own build of the host C++; keep the shared host modules
# of the JAX package from loading that package's prebuilt binary.
os.environ.setdefault("CIRCUITS_TPU_NO_NATIVE", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
TESTS = ROOT / "tests"
SEED = 0
CRITERION = (20, 1, 8, 13)  # LEVELS, N_CURRENCIES, N_BYTES, k (BASELINE.md:10)
G1_GEN = (1, 2)  # the BN254 G1 generator, affine


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
    from circuits_halo2_tpu_torch import native
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK

    for logn in (11, 13):
        n = 1 << logn
        points = native.g1_fixed_base_muls(G1_GEN, random_fr(rng, n))
        points[3] = None
        points[9] = (points[8][0], FT.FQ.mod_int - points[8][1])  # -P
        rows = [random_fr(rng, n) for _ in range(4)]
        rows[0][0], rows[0][1] = 0, FT.FR.mod_int - 1
        rows[0][8] = rows[0][9]  # P + (-P) in one bucket
        scal = torch.as_tensor(FT.to_mont_limbs([v for r in rows for v in r]).reshape(16, 4, n),
                               device=device)
        xs, ys, valid = M.precompute_bases(points, device)
        px, py, pv, seg, L = sorted_scan_inputs(xs, ys, valid, scal)
        got = MK.segmented_scan(px, py, pv, seg, L)
        want = MK.segmented_scan_ref(px, py, pv, seg, L)
        err = max_abs_err(got, want)
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K3 differs from its plain version at n=2^{logn}")
        report["k3_err"] = max(report.get("k3_err", 0), err)
        log(f"K3 n=2^{logn} batch=4 L={L}: limb-exact against plain torch")
        if logn == 13:
            commits = M.msm_commit_dev(points, scal)
            host = [native.g1_msm(points, r) for r in rows]
            if commits != host:
                raise AssertionError("msm_commit_dev differs from native g1_msm at 2^13")
            log("msm_commit_dev at 2^13 x 4 (zero scalar, p-1, P+(-P), None base) == native g1_msm")


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
        want = host_tree_root(digests, balances)
        if root != want:
            raise AssertionError(f"device root {root} != host root {want}")
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


def timings(device, rng, card):
    """Kernel vs plain torch at the main path's shapes (CUDA events)."""
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.utils.srs import setup_cached

    out = {}
    n = 1 << 20
    for length in (2, 3):  # leaf and middle levels of the 1-currency tree
        inp = torch.stack([torch.as_tensor(FT.to_mont_limbs(random_fr(rng, n)), device=device)
                           for _ in range(length)])
        k_ms = cuda_ms(lambda: PK.hash_batch(inp), 5)
        p_ms = cuda_ms(lambda: PK.hash_batch_ref(inp), 1, warm=False)
        out[f"k1_L{length}"] = (k_ms, p_ms)
        log(f"K1 2^20 L={length}: kernel {k_ms:.3f} ms, plain torch {p_ms:.3f} ms ({card})")
    params = setup_cached(13)
    xs, ys, valid = M.precompute_bases(params.g_lagrange, device)
    scal = torch.as_tensor(
        FT.to_mont_limbs(random_fr(rng, 3 << 13)).reshape(16, 3, 1 << 13), device=device)
    px, py, pv, seg, L = sorted_scan_inputs(xs, ys, valid, scal)
    k_ms = cuda_ms(lambda: MK.segmented_scan(px, py, pv, seg, L), 5)
    p_ms = cuda_ms(lambda: MK.segmented_scan_ref(px, py, pv, seg, L), 1, warm=False)
    out["k3"] = (k_ms, p_ms)
    log(f"K3 k=13 commit batch 3 (lanes {px[0].numel() // L}, L={L}): kernel {k_ms:.3f} ms, "
        f"plain torch {p_ms:.3f} ms ({card})")
    return out


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

    with Phase("kernel build (nvcc sm_90a)"):
        lib, seconds, ptxas = build.compile_cuda()
        build.cuda_library()
        log(f"built {lib.name} in {seconds:.1f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    report: dict = {}
    with Phase("K1 vs plain"):
        check_k1(device, rng, report)
    with Phase("K3 vs plain"):
        check_k3(device, rng, report)

    PK.hash_batch.launches = 0
    MK.segmented_scan.launches = 0
    criterion(device)
    entry16(device)
    launches = {"k1": PK.hash_batch.launches, "k3": MK.segmented_scan.launches}
    log(f"main-path launches: K1 {launches['k1']}, K3 {launches['k3']}")
    if not launches["k1"] or not launches["k3"]:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    with Phase("kernel vs plain timings"):
        times = timings(device, rng, card)

    summary = {"kernels": [
        {"name": "poseidon_sponge", "route": "cuda",
         "source": "circuits_halo2_tpu_torch/csrc/poseidon.cu",
         "replaces": "circuits_halo2_tpu/ops/poseidon_pallas2.py:310",
         "launches": launches["k1"], "max_abs_err": report["k1_err"],
         "ms": times["k1_L2"][0], "plain_ms": times["k1_L2"][1]},
        {"name": "msm_bucket_scan", "route": "cuda",
         "source": "circuits_halo2_tpu_torch/csrc/msm_scan.cu",
         "replaces": "circuits_halo2_tpu/ops/msm_pallas.py:438",
         "launches": launches["k3"], "max_abs_err": report["k3_err"],
         "ms": times["k3"][0], "plain_ms": times["k3"][1]},
    ]}
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
