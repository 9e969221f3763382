"""Address-ownership registration.

Parity target: `backend/src/apis/address_ownership.rs:6-38` +
`backend/src/apis/csv_parser.rs:27-47`: parse the ``;``-separated
``signatures.csv`` (chain;address;signature;message) and submit the proofs
through the signer.
"""

from __future__ import annotations

import csv

from ..contracts.summa_sim import AddressOwnershipProof
from .signer import SummaSigner


def parse_signature_csv(path: str) -> list[AddressOwnershipProof]:
    proofs = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter=";")
        for record in reader:
            proofs.append(
                AddressOwnershipProof(
                    cex_address=record["address"],
                    chain=record["chain"],
                    signature=record["signature"],
                    message=record["message"],
                )
            )
    return proofs


class AddressOwnership:
    def __init__(self, signer: SummaSigner, signatures_csv_path: str):
        self.signer = signer
        self.address_ownership_proofs = parse_signature_csv(signatures_csv_path)

    def dispatch_proof_of_address_ownership(self):
        self.signer.submit_proof_of_address_ownership(self.address_ownership_proofs)
