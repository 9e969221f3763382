"""In-process behavioral model of the on-chain layer.

Semantic parity targets:
- ``Summa.sol`` registrar (`contracts/src/Summa.sol:11-220`): address
  ownership registration with keccak dedup, liabilities commitments with
  validation, and inclusion-proof verification that checks the public
  inputs against the stored commitment before delegating to the verifier.
- ``InclusionVerifier.sol``: delegated to the framework verifier over the
  same calldata encoding (proof bytes + U256 instances).

The reference exercises these against an Anvil devnet; this environment has
no EVM node, so the simulation implements the same state machine in-process
(the Solidity sources themselves are produced by contracts/sol_generator).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.keccak import keccak256


@dataclass
class AddressOwnershipProof:
    cex_address: str
    chain: str
    signature: str
    message: str


@dataclass
class Cryptocurrency:
    name: str
    chain: str


@dataclass
class Commitment:
    mst_root: int
    root_balances: list[int]
    cryptocurrencies: list[Cryptocurrency]
    timestamp: int


class SummaContractSim:
    """The Summa registrar state machine."""

    def __init__(
        self,
        verifier,
        mst_levels: int,
        currencies_count: int,
        balance_byte_range: int,
        owner: str = "0xowner",
    ):
        self.config = (mst_levels, currencies_count, balance_byte_range)
        self.owner = owner
        self.verifier = verifier  # callable (proof_bytes, instances) -> bool
        self.address_ownership_proofs: list[AddressOwnershipProof] = []
        self._ownership_seen: set[bytes] = set()
        self.commitments: dict[int, Commitment] = {}
        self.events: list[tuple] = []

    # -- ownership ----------------------------------------------------------

    def submit_proof_of_address_ownership(
        self, sender: str, proofs: list[AddressOwnershipProof]
    ):
        self._only_owner(sender)
        for proof in proofs:
            # dedup key is keccak(cexAddress) alone (Summa.sol:116-120)
            key = keccak256(proof.cex_address.encode("utf-8"))
            if key in self._ownership_seen:
                raise ValueError("Address already verified")
            self._ownership_seen.add(key)
            self.address_ownership_proofs.append(proof)
            if not (
                proof.cex_address and proof.chain
                and proof.signature and proof.message
            ):
                raise ValueError("Invalid proof of address ownership")
        self.events.append(("AddressOwnershipProofSubmitted", list(proofs)))

    def get_address_ownership_proof(self, address_hash: bytes) -> AddressOwnershipProof:
        """Summa.sol:70-80 getAddressOwnershipProof."""
        for proof in self.address_ownership_proofs:
            if keccak256(proof.cex_address.encode("utf-8")) == address_hash:
                return proof
        raise ValueError("Address not verified")

    # -- commitments --------------------------------------------------------

    def submit_commitment(
        self,
        sender: str,
        mst_root: int,
        root_balances: list[int],
        cryptocurrencies: list[Cryptocurrency],
        timestamp: int,
    ):
        self._only_owner(sender)
        if mst_root == 0:
            raise ValueError("Invalid MST root")
        if len(cryptocurrencies) != len(root_balances):
            raise ValueError(
                "Root liabilities sums and liabilities number mismatch"
            )
        for c, bal in zip(cryptocurrencies, root_balances):
            if not c.chain or not c.name:
                raise ValueError("Invalid cryptocurrency")
            if bal == 0:
                raise ValueError("All root sums should be greater than zero")
        self.commitments[timestamp] = Commitment(
            mst_root, list(root_balances), list(cryptocurrencies), timestamp
        )
        self.events.append(
            ("LiabilitiesCommitmentSubmitted", timestamp, mst_root, root_balances)
        )

    # -- verification -------------------------------------------------------

    def verify_inclusion_proof(
        self, proof: bytes, public_inputs: list[int], timestamp: int
    ) -> bool:
        commitment = self.commitments.get(timestamp)
        if commitment is None or commitment.mst_root != public_inputs[1]:
            raise ValueError("Invalid root hash")
        for i in range(2, len(public_inputs)):
            if commitment.root_balances[i - 2] != public_inputs[i]:
                raise ValueError("Invalid root balance")
        try:
            return bool(self.verifier(proof, public_inputs))
        except Exception:
            # Summa.sol:211-216: a verifier-level exception is surfaced as a
            # revert with this message (not a false return)
            raise ValueError("Invalid inclusion proof") from None

    def _only_owner(self, sender: str):
        if sender != self.owner:
            raise PermissionError("Ownable: caller is not the owner")
