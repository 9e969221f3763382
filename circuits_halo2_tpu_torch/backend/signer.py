"""Transaction signer for the operator backend.

Parity target: `backend/src/contracts/signer.rs:20-133` (SummaSigner):
address resolution from a literal or from ``deployments.json`` keyed by
chain id, and a nonce lock serializing concurrent submissions
(`signer.rs:91-129` — the reference's tokio-Mutex race fix, covered by the
concurrent-submission test `backend/src/tests.rs:146-191`).

The transport is injectable: the in-process ``SummaContractSim`` stands in
for an RPC provider + deployed contract in this chainless environment; a
web3 transport can be slotted in unchanged where a node is available.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass

from ..contracts.summa_sim import AddressOwnershipProof, SummaContractSim


@dataclass
class AddressInput:
    """Contract address: literal or resolved from a deployments file."""

    address: str | None = None
    deployments_path: str | None = None
    chain_id: int | None = None

    def resolve(self) -> str:
        if self.address is not None:
            return self.address
        with open(self.deployments_path) as f:
            deployments = json.load(f)
        record = deployments[str(self.chain_id)]
        return record["address"] if isinstance(record, dict) else record


class SummaSigner:
    def __init__(self, signing_key: str, contract: SummaContractSim, sender: str):
        self.signing_key = signing_key
        self.contract = contract
        self.sender = sender
        self._nonce_lock = threading.Lock()
        self.nonce = 0

    def _send(self, fn, *args):
        """Serialize submissions so concurrent rounds can't collide on the
        account nonce (`signer.rs:91-104`)."""
        with self._nonce_lock:
            result = fn(self.sender, *args)
            self.nonce += 1
            return result

    def submit_proof_of_address_ownership(self, proofs: list[AddressOwnershipProof]):
        return self._send(self.contract.submit_proof_of_address_ownership, proofs)

    def submit_commitment(self, mst_root, root_balances, cryptocurrencies, timestamp):
        return self._send(
            self.contract.submit_commitment,
            mst_root,
            root_balances,
            cryptocurrencies,
            timestamp,
        )
