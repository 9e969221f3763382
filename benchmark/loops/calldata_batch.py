"""Bulk inclusion calldata through ``utils/pipeline.gen_proofs_solidity_calldata``:
the EVM path of an operator's round, every proof checked before export.

Set-up as ``prove_batch``'s loop: the snapshot's leaves from the seed, the
unsafe SRS of 2^k points and keygen (the SRS read from the build directory
after the first run), the device tree (K1) and its root, and one cold call
on the first U users of the seeded order. A step is one closed-loop call
for the next U users, none proved before in the run: each user's Merkle
path and ``MstInclusionCircuit`` (as ``prove_batch``'s loop), then the batched
calldata function: ``prove_batch`` with the Keccak transcript, every
proof's transcript replayed and the U accumulators folded into one pairing
check, then the encoding, the call ended by a synchronise. A call that
raises (the prover's refusal or the self-check's) exports nothing: its
users count as failed.

In the traced window the loop turns the port's ``utils/tracing`` on around
each step and drains it after; ``counts()`` carries the ``self_check``
spans' nanoseconds and the ``verify`` counts (pairing checks, proofs
replayed) to the per-layer readers.

Judged after the window, against ``benchmark/reference`` only: the root,
the verifying key, every proved user's witness and instances, every
calldata's public inputs against the reference instances' hex, and every
proof under the reference's Keccak verifier (``verifier_keccak``).
"""

from __future__ import annotations

import random
import sys
import time

from . import prove_batch as PB


class Loop(PB.Loop):
    def __init__(self, cell, seed: int, device, spans):
        super().__init__(cell, seed, device, spans)
        self.exported: dict[bytes, list[str]] = {}
        self.traced = {"self_check_ns": 0, "verify_pairings": 0, "verify_proofs": 0}

    # -- the program ---------------------------------------------------------

    def setup(self) -> None:
        # a program without the batched calldata path fails here, at once
        from circuits_halo2_tpu_torch.utils.pipeline import gen_proofs_solidity_calldata  # noqa: F401

        super().setup()

    def prove(self, circuits, instances, users) -> list[bytes]:
        """The U users' calldata; returns the proofs' bytes and keeps each
        proof's public inputs for the judgement."""
        import torch

        from circuits_halo2_tpu_torch.models.prover import BlindingRng
        from circuits_halo2_tpu_torch.utils import pipeline

        rngs = [BlindingRng(f"bench:{self.seed}:{int(u)}".encode()) for u in users]
        calldata = pipeline.gen_proofs_solidity_calldata(self.art, circuits, rngs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        proofs = [bytes.fromhex(cd.proof[2:]) for cd in calldata]
        self.exported.update(zip(proofs, (cd.public_inputs for cd in calldata)))
        return proofs

    def step(self, record: bool = True) -> None:
        if not self.spans.on:
            super().step(record)
            return
        from circuits_halo2_tpu_torch.utils import tracing

        tracing.enable()
        try:
            super().step(record)
        finally:
            tracing.disable()
            spans, counts = tracing.drain()
            self.traced["self_check_ns"] += sum(s.end - s.start for s in spans
                                                if s.name == "self_check")
            self.traced["verify_pairings"] += counts.get(("verify", "pairings"), {}).get("n", 0)
            self.traced["verify_proofs"] += counts.get(("verify", "proofs"), {}).get("n", 0)

    def counts(self) -> dict[str, int]:
        return {"proofs": self.proofs, **self.traced}

    # -- the judgement ---------------------------------------------------------

    def judge(self) -> tuple[dict[str, tuple[float, float]], int, int]:
        """({check: (value, limit)}, attempted, failed)."""
        from ..reference import keygen as RK
        from ..reference import verifier_keccak as RV
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
        path_mismatch = calldata_mismatch = unreadable = 0
        combos = []
        for u, wit, inst, proof in self.records:
            want = ref.path(u)
            want_inst = [[want["leaf_hash"], want["root_hash"]] + want["root_balances"]]
            if (wit != PB.expected_witness(self.digests, self.balances, u, want)
                    or inst != want_inst):
                path_mismatch += 1
            if self.exported.get(proof) != [hex(v) for v in want_inst[0]]:
                calldata_mismatch += 1
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
              f"{len(self.records)} paths, calldata and Keccak proofs {t3 - t2:.2f} s",
              file=sys.stderr)
        checks = {"root_mismatch": (root_mismatch, 0), "vk_mismatch": (vk_mismatch, 0),
                  "path_mismatch": (path_mismatch, 0),
                  "calldata_mismatch": (calldata_mismatch, 0),
                  "proofs_failed": (proofs_failed, 0)}
        return checks, len(self.records), proofs_failed
