"""CEX-operator API: rounds, snapshots, inclusion proofs.

Parity target: `backend/src/apis/round.rs:26-175`. A ``Snapshot`` owns the
Merkle sum tree plus the trusted-setup artifacts (k parsed from the ptau
filename suffix, `round.rs:139-142`); a ``Round`` binds a snapshot to a
timestamp and a signer and can (a) dispatch the liabilities commitment
on-chain and (b) produce per-user inclusion-proof calldata.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..merkle.mst import MerkleSumTree
from ..models.mst_inclusion import MstInclusionCircuit
from ..utils import pipeline
from ..contracts.summa_sim import Cryptocurrency


@dataclass
class MstInclusionProof:
    proof_calldata: str          # 0x hex proof bytes
    public_inputs: list[str]     # U256 hex strings

    def get_public_inputs(self) -> list[str]:
        return self.public_inputs

    def get_proof(self) -> str:
        return self.proof_calldata


class Snapshot:
    def __init__(
        self,
        mst: MerkleSumTree,
        params_path: str,
        levels: int,
        n_currencies: int,
        n_bytes: int,
        device="cuda:0",
    ):
        # k parsed from the ptau filename suffix, e.g. "hermez-raw-11" → 11
        k = int(params_path.split("-")[-1])
        self.mst = mst
        self.trusted_setup = pipeline.generate_setup_artifacts(
            k, params_path, levels, n_currencies, n_bytes, device=device
        )
        self.shape = (levels, n_currencies, n_bytes)

    def generate_proof_of_inclusion(self, user_index: int) -> MstInclusionProof:
        levels, n_currencies, n_bytes = self.shape
        merkle_proof = self.mst.generate_proof(user_index)
        circuit = MstInclusionCircuit.init(levels, n_currencies, n_bytes, merkle_proof)
        calldata = pipeline.gen_proof_solidity_calldata(self.trusted_setup, circuit)
        return MstInclusionProof(calldata.proof, calldata.public_inputs)


class Round:
    def __init__(
        self,
        signer,
        mst: MerkleSumTree,
        params_path: str,
        timestamp: int,
        levels: int,
        n_currencies: int,
        n_bytes: int,
        device="cuda:0",
    ):
        self.timestamp = timestamp
        self.snapshot = Snapshot(
            mst, params_path, levels, n_currencies, n_bytes, device=device
        )
        self.signer = signer

    def dispatch_commitment(self):
        """Submit (root_hash, root_balances, currencies) for this round's
        timestamp (`round.rs:78-110`)."""
        root = self.snapshot.mst.root
        cryptos = [
            Cryptocurrency(c.name, c.chain)
            for c in self.snapshot.mst.cryptocurrencies
        ]
        self.signer.submit_commitment(
            root.hash, list(root.balances), cryptos, self.timestamp
        )

    def get_proof_of_inclusion(self, user_index: int) -> MstInclusionProof:
        return self.snapshot.generate_proof_of_inclusion(user_index)
