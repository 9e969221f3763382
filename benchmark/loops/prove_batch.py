"""Bulk inclusion proofs through ``models/prover_batch.prove_batch``.

Set-up: the snapshot's leaves from the seed, the unsafe SRS of 2^k points
and keygen (``utils/pipeline.generate_setup_artifacts``; the SRS is read
from the build directory after the first run), the device tree (K1) and
its root, and one cold call on the first U users of the seeded order. A
step is one closed-loop call for the next U users, none proved before in
the run: each user's Merkle path from the set-up tree, its
``MstInclusionCircuit``, its instances, and the U proofs (Blake2b
transcript), the call ended by a synchronise. A call that raises makes no
proofs: its users count as failed.

Judged after the window, against ``benchmark/reference`` only: the root,
the verifying key, every proved user's witness and instances, and every
proof of the window (each verified under the reference's key and
instances; a proof missing from a call counts as failed).
"""

from __future__ import annotations

import random
import sys
import time

from .. import traffic as T


class Loop:
    kind = "prove"

    def __init__(self, cell, seed: int, device, spans):
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.spans = spans
        self.users_per_call = int(self.traffic["users_per_call"])
        self.rngs = T.streams(seed)
        self.records: list[tuple[int, tuple, list, bytes | None]] = []
        self.proofs = 0
        self.next = 0

    # -- the program ---------------------------------------------------------

    def setup(self) -> None:
        from circuits_halo2_tpu_torch.merkle.device_tree import build_device_tree
        from circuits_halo2_tpu_torch.utils import pipeline

        c = self.config
        self.digests, self.balances = T.leaves(self.rngs["leaves"], c)
        self.order = T.order(self.rngs["order"], c)
        self.art = pipeline.generate_setup_artifacts(c["k"], None, c["levels"],
                                                     c["n_currencies"], c["n_bytes"], self.device)
        self.tree = build_device_tree(self.digests, self.balances, self.device)
        self.root = self.tree.root()
        self.step(record=False)

    def circuits(self, users):
        """Each user's path, circuit and instances."""
        from circuits_halo2_tpu_torch.models.mst_inclusion import MstInclusionCircuit

        c = self.config
        out = []
        for u in users:
            path = self.tree.generate_proof(int(u), T.entry(self.digests, self.balances, int(u)))
            circuit = MstInclusionCircuit.init(c["levels"], c["n_currencies"], c["n_bytes"], path)
            out.append((circuit, circuit.instances()))
        return out

    def prove(self, circuits, instances, users) -> list[bytes]:
        import torch

        from circuits_halo2_tpu_torch.models.prover import BlindingRng
        from circuits_halo2_tpu_torch.models.prover_batch import prove_batch
        from circuits_halo2_tpu_torch.utils.transcript import Blake2bTranscript

        rngs = [BlindingRng(f"bench:{self.seed}:{int(u)}".encode()) for u in users]
        proofs = prove_batch(self.art.params, self.art.pk, circuits, self.art.config, instances,
                             rngs=rngs, transcript_cls=Blake2bTranscript,
                             vk_digest=self.art.vk.transcript_repr, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return proofs

    def step(self, record: bool = True) -> None:
        users = self.order[self.next:self.next + self.users_per_call]
        self.next += len(users)
        with self.spans.span("paths+circuits"):
            made = self.circuits(users)
        with self.spans.span("prove_batch"):
            try:
                proofs = self.prove([m[0] for m in made], [m[1] for m in made], users)
            except (ValueError, AssertionError, RuntimeError) as e:
                if not record:
                    raise
                print(f"prove_batch failed for users {list(map(int, users))}: {e!r}",
                      file=sys.stderr, flush=True)
                proofs = []  # the call's proofs count as failed
        if not record:
            return
        self.proofs += len(users)
        for i, (u, (circuit, inst)) in enumerate(zip(users, made)):
            self.records.append((int(u), witness(circuit), inst,
                                 proofs[i] if i < len(proofs) else None))

    def end_to_end(self, elapsed_s: float) -> dict[str, float]:
        return {"proofs_per_s": self.proofs / elapsed_s}

    def counts(self) -> dict[str, int]:
        return {"proofs": self.proofs}

    def free(self) -> None:
        vk = self.art.vk
        self.program_vk = (list(vk.fixed_commitments), list(vk.permutation_commitments),
                           vk.transcript_repr)
        del self.art, self.tree

    # -- the judgement ---------------------------------------------------------

    def judge(self) -> tuple[dict[str, tuple[float, float]], int, int]:
        """({check: (value, limit)}, attempted, failed)."""
        from ..reference import keygen as RK
        from ..reference import verifier as RV
        from ..reference.tree import Tree

        c = self.config
        t0 = time.perf_counter()
        ref = Tree(self.digests, self.balances, self.device)
        t1 = time.perf_counter()
        vk = RK.verifying_key(c["levels"], c["n_currencies"], c["n_bytes"], c["k"])
        t2 = time.perf_counter()
        fixed, perm, repr_ = self.program_vk
        vk_mismatch = (sum(a != b for a, b in zip(fixed, vk.fixed_commitments))
                       + sum(a != b for a, b in zip(perm, vk.permutation_commitments))
                       + abs(len(fixed) - len(vk.fixed_commitments))
                       + abs(len(perm) - len(vk.permutation_commitments))
                       + (repr_ != vk.transcript_repr))
        root_mismatch = int(self.root != ref.root())
        path_mismatch = unreadable = 0
        combos = []
        for u, wit, inst, proof in self.records:
            want = ref.path(u)
            want_inst = [[want["leaf_hash"], want["root_hash"]] + want["root_balances"]]
            if wit != expected_witness(self.digests, self.balances, u, want) or inst != want_inst:
                path_mismatch += 1
            try:
                if proof is None:
                    raise ValueError("no proof")
                combos.append(RV.verify(vk, want_inst, proof))
            except ValueError:
                unreadable += 1
        rng = random.Random(int(self.rngs["sample"].integers(1 << 62)))
        proofs_failed = unreadable
        if combos and not RV.check(combos, rng):
            proofs_failed += sum(not RV.check([lc], rng) for lc in combos)
        t3 = time.perf_counter()
        print(f"reference: tree {t1 - t0:.2f} s, verifying key {t2 - t1:.2f} s, "
              f"{len(self.records)} paths and proofs {t3 - t2:.2f} s", file=sys.stderr)
        checks = {"root_mismatch": (root_mismatch, 0), "vk_mismatch": (vk_mismatch, 0),
                  "path_mismatch": (path_mismatch, 0), "proofs_failed": (proofs_failed, 0)}
        return checks, len(self.records), proofs_failed


def witness(circuit) -> tuple:
    """What a circuit took from the tree and the entry."""
    return (circuit.entry_username, list(circuit.entry_balances),
            list(circuit.sibling_leaf_node_hash_preimage),
            [list(m) for m in circuit.sibling_middle_node_hash_preimages],
            list(circuit.path_indices), circuit.root_hash, list(circuit.root_balances))


def expected_witness(digests, balances, u: int, want: dict) -> tuple:
    from ..reference.field import FR_MOD

    return (int.from_bytes(digests[u].tobytes(), "big") % FR_MOD,
            [int(b) % FR_MOD for b in balances[u]], want["sibling_leaf"],
            want["sibling_middles"], want["path"], want["root_hash"], want["root_balances"])
