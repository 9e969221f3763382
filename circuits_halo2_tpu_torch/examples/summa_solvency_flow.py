"""The operator's round, end to end (``examples/summa_solvency_flow.py``):
1) submit the address-ownership proofs, 2) dispatch the liabilities
commitment, 3) export a user's inclusion-proof calldata JSON, 4) check it
as the user does (the leaf hash re-derived from the username and balances,
the on-chain root, ``verifyInclusionProof``).

The chain is the in-process Summa simulation (``contracts/summa_sim``);
every other stage is the port's pipeline on ``--device``.

    python -m circuits_halo2_tpu_torch.examples.summa_solvency_flow [--device cpu] [--out DIR]
"""

import json
import time

from ..backend.address_ownership import AddressOwnership
from ..backend.apis import leaf_hash_from_inputs
from ..backend.round import Round
from ..backend.signer import SummaSigner
from ..contracts.summa_sim import SummaContractSim
from ..merkle.mst import MerkleSumTree
from ..models.verifier import verify
from ..utils.transcript import KeccakTranscript
from . import _common

USER_INDEX = 0


def main(argv=None):
    """Runs the round; returns the exported calldata and the ``Round``."""
    args = _common.parser(__doc__.splitlines()[0]).parse_args(argv)
    levels, ncur, nbytes = _common.LEVELS, _common.N_CURRENCIES, _common.N_BYTES

    # 0. deploy: the on-chain verifier is the port's verifier
    artifacts_box = {}

    def onchain_verifier(proof_bytes, instances):
        art = artifacts_box["artifacts"]
        return verify(art.params, art.vk, [instances], proof_bytes,
                      transcript_cls=KeccakTranscript)

    summa = SummaContractSim(onchain_verifier, levels, ncur, nbytes)
    signer = SummaSigner("0x" + "11" * 32, summa, sender=summa.owner)

    # 1. ownership proofs
    ownership = AddressOwnership(signer, str(_common.CSV_DIR / "signatures.csv"))
    ownership.dispatch_proof_of_address_ownership()
    print(f"1. Ownership proofs registered ({len(summa.address_ownership_proofs)})")

    # 2. build the snapshot and commit liabilities
    timestamp = 1
    mst = MerkleSumTree.from_csv(str(_common.CSV_DIR / "entry_16.csv"), args.device)
    t0 = time.time()
    round_ = Round(signer, mst, str(_common.PTAU), timestamp, levels, ncur, nbytes,
                   device=args.device)
    artifacts_box["artifacts"] = round_.snapshot.trusted_setup
    round_.dispatch_commitment()
    print(f"2. Commitment submitted (setup {time.time() - t0:.0f}s)")

    # 3. per-user inclusion proof
    t0 = time.time()
    proof = round_.get_proof_of_inclusion(USER_INDEX)
    data = {"proof": proof.proof_calldata, "public_inputs": proof.public_inputs}
    out = _common.out_dir(args) / "inclusion_proof_solidity_calldata.json"
    out.write_text(json.dumps(data))
    print(f"3. Inclusion proof exported ({time.time() - t0:.0f}s) -> {out}")

    # 4. user-side verification
    entry = mst.entries[USER_INDEX]
    expected_leaf = leaf_hash_from_inputs(entry.username, [str(b) for b in entry.balances])
    if expected_leaf != int(proof.public_inputs[0], 16):
        raise SystemExit("leaf hash mismatch")
    if summa.commitments[timestamp].mst_root != int(proof.public_inputs[1], 16):
        raise SystemExit("root mismatch")
    if not summa.verify_inclusion_proof(bytes.fromhex(proof.proof_calldata[2:]),
                                        [int(v, 16) for v in proof.public_inputs], timestamp):
        raise SystemExit("on-chain verification failed")
    print("4. User-side verification passed — round complete")
    return data, round_


if __name__ == "__main__":
    main()
