"""Rank tasks of the port's mesh tests, run by ``parallel/worker.launch``
in worker processes (so they import only the port, numpy and torch), and
the seeded inputs that the tests hand the JAX package for its references.

- ``kernels``: the sharded NTT (host ints, a round trip, a batch against
  the single-device transform), the sharded MSM and commitment, and the
  sharded leaf hash, tree step and tree reduce;
- ``prove_entry16``: keygen and a Keccak proof of entry_16 user 0 at k=11
  under the mesh, verified, with a flipped byte rejected;
- ``nccl_commit``: the sharded commitment of 2048 lanes against the
  single-device one (``tests/test_torch_cuda.py``, a 1-rank NCCL world);
- ``fail_on_rank_1``: rank 1 raises while rank 0 waits in a collective.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.ops import field as F
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import msm as M
from circuits_halo2_tpu_torch.ops import ntt as NTT
from circuits_halo2_tpu_torch.parallel import auto, msm_sharded, ntt_sharded, sharding

HERE = Path(__file__).resolve().parent
G1_GEN = (1, 2)
COMMIT_LANES = 2048


def fr_values(seed: int, count: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(count)]


def msm_inputs():
    """64 points and two scalar rows (random, all zero)."""
    rng = np.random.default_rng(5)
    points = native.g1_fixed_base_muls(G1_GEN, [int(v) for v in rng.integers(1, 1 << 62, 64)])
    return points, [fr_values(6, 64), [0] * 64]


def commit_inputs():
    """2048 lanes: 64 points repeated, 62-bit scalars."""
    rng = np.random.default_rng(3)
    points = native.g1_fixed_base_muls(G1_GEN, [int(v) for v in rng.integers(1, 1 << 62, 64)])
    points = points * (COMMIT_LANES // 64)
    return points, [int(v) for v in rng.integers(0, 1 << 62, COMMIT_LANES)]


def tree_inputs():
    """16 leaf preimages (username, 2 balances), as the JAX multi-process
    worker builds them."""
    return [[i + 1, 10 + i, 20 + i] for i in range(16)]


def _hex(values) -> list[str]:
    return [hex(v) for v in values]


def _point(p):
    return None if p is None else _hex(p)


def _mont(values, device) -> torch.Tensor:
    return torch.as_tensor(FT.to_mont_limbs(values), device=device)


def kernels(mesh) -> dict:
    dev = mesh.device
    out = {"rank": mesh.rank, "size": mesh.size}

    # sharded NTT: host ints at 2^10, a round trip at 2^9, a (16, 3, 2^12) batch
    out["ntt_1024"] = _hex(ntt_sharded.ntt_sharded_host(mesh, fr_values(1, 1 << 10),
                                                        NTT.omega_for_k(10)))
    vals, omega = fr_values(2, 1 << 9), NTT.omega_for_k(9)
    fwd = ntt_sharded.ntt_sharded_host(mesh, vals, omega)
    back = ntt_sharded.ntt_sharded_host(mesh, fwd, F.fr_inv(omega))
    n_inv = F.fr_inv(1 << 9)
    out["roundtrip_ok"] = [v * n_inv % F.FR_MOD for v in back] == vals
    a = _mont(fr_values(3, 3 << 12), dev).reshape(FT.NLIMBS, 3, 1 << 12)
    got = ntt_sharded.ntt_sharded_batched(mesh, a, NTT.omega_for_k(12))
    out["ntt_batched_equal"] = torch.equal(got, NTT._ntt_device(a, NTT.omega_for_k(12)))
    out["ntt_batched_sha256"] = hashlib.sha256(got.numpy().tobytes()).hexdigest()

    # sharded MSM of host rows, and a commitment through the prover's seam
    points, rows = msm_inputs()
    out["msm"] = [_point(p) for p in msm_sharded.msm_sharded(mesh, points, rows)]
    cpoints, scal = commit_inputs()
    mont = _mont(scal, dev).reshape(FT.NLIMBS, 1, COMMIT_LANES)
    auto.set_mesh(mesh)
    before = mesh.sharded.get("msm", 0)
    out["commit_mesh"] = _point(M.msm_commit_dev(cpoints, mont)[0])
    out["commit_routed"] = mesh.sharded.get("msm", 0) - before
    with auto.suspended():
        out["commit_single"] = _point(M.msm_commit_dev(cpoints, mont)[0])
    auto.clear_mesh()
    xs, ys, valid = M.precompute_bases(cpoints, dev)
    windows = msm_sharded.msm_sharded_device(mesh, xs, ys, valid, M.digits_from_mont(mont))
    out["msm_device"] = _point(M._combine_windows_host(windows)[0])

    # sharded leaf hashes, one tree level and the root
    pre = tree_inputs()
    inputs = torch.stack([_mont([p[i] for p in pre], dev) for i in range(3)])  # (3, 16, 16)
    leaf_hashes = sharding.sharded_hash_batch(mesh, inputs)
    balances = inputs[1:].movedim(0, 1)  # (16, 2, 16)
    h1, b1 = sharding.sharded_tree_step(mesh, leaf_hashes, balances)
    root_h, root_b = sharding.sharded_tree_reduce(mesh, leaf_hashes, balances)
    out["leaves"] = _hex(FT.from_mont_ints(leaf_hashes))
    out["level1"] = [_hex(FT.from_mont_ints(h1)),
                     [_hex(FT.from_mont_ints(b1[:, c])) for c in range(2)]]
    out["root"] = [hex(FT.from_mont_ints(root_h)[0]),
                   [hex(FT.from_mont_ints(root_b[:, c])[0]) for c in range(2)]]
    out["sharded"] = mesh.sharded
    out["collectives"] = mesh.stats.calls
    return out


def prove_entry16(mesh) -> dict:
    """Keygen and the Keccak proof of tests/fixtures_torch_proofs.json under
    the mesh; how many MSMs and NTTs went through it."""
    from circuits_halo2_tpu_torch.merkle.mst import MerkleSumTree
    from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit
    from circuits_halo2_tpu_torch.models.verifier import verify
    from circuits_halo2_tpu_torch.utils import pipeline
    from circuits_halo2_tpu_torch.utils.transcript import KeccakTranscript

    fix = json.loads((HERE / "fixtures_torch_proofs.json").read_text())
    vk_digest = int(json.loads((HERE / "fixtures_vk_inclusion.json").read_text())["vk_digest"], 16)
    auto.set_mesh(mesh)
    art = pipeline.generate_setup_artifacts(
        fix["k"], str(HERE / "fixtures_ptau_hermez-raw-11"), fix["levels"],
        fix["n_currencies"], fix["n_bytes"], mesh.device)
    tree = MerkleSumTree.from_csv(str(HERE / fix["csv"]), mesh.device)
    circuit = MstInclusionCircuit.init(fix["levels"], fix["n_currencies"], fix["n_bytes"],
                                       tree.generate_proof(fix["user_index"]))
    proof = bytes.fromhex(pipeline.gen_proof_solidity_calldata(art, circuit,
                                                               vk_digest=vk_digest).proof[2:])
    sharded = dict(mesh.sharded)
    auto.clear_mesh()
    instances = circuit.instances()
    flipped = bytearray(proof)
    flipped[100] ^= 1

    def verifies(p):  # a malformed proof raises, as in pipeline.full_verifier
        try:
            return verify(art.params, art.vk, instances, bytes(p),
                          transcript_cls=KeccakTranscript, vk_digest=vk_digest)
        except (ValueError, AssertionError, KeyError):
            return False

    return {"rank": mesh.rank,
            "fixed": [_hex(p) for p in art.vk.fixed_commitments],
            "permutation": [_hex(p) for p in art.vk.permutation_commitments],
            "transcript_repr": hex(art.vk.transcript_repr),
            "proof": proof.hex(), "verifies": verifies(proof),
            "flipped_rejected": not verifies(flipped),
            "sharded": sharded, "collectives": mesh.stats.calls}


def nccl_commit(mesh) -> dict:
    import torch.distributed as dist

    points, scal = commit_inputs()
    mont = _mont(scal, mesh.device).reshape(FT.NLIMBS, 1, COMMIT_LANES)
    xs, ys, valid = M.precompute_bases(points, mesh.device)
    got = M._combine_windows_host(msm_sharded.commit_sharded_device(mesh, xs, ys, valid, mont))
    want = M._combine_windows_host(M._commit_dev(xs, ys, valid, mont))
    return {"backend": dist.get_backend(), "equal": got == want, "point": _point(got[0]),
            "collectives": mesh.stats.calls}


def fail_on_rank_1(mesh) -> None:
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    mesh.all_gather(torch.zeros(1))
