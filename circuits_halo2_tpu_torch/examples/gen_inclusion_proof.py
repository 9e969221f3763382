"""Prove one user's inclusion and check it in the EVM interpreter
(``examples/gen_inclusion_proof.py``): build the Merkle sum tree of
``entry_16.csv``, prove user 0 on ``--device`` with the EVM transcript,
export the calldata JSON, and run the verifier generated from the VK
(``contracts/sol_generator``) on it in ``contracts/yul_vm``, printing its
gas.

    python -m circuits_halo2_tpu_torch.examples.gen_inclusion_proof [--device cpu] [--out DIR]
"""

import json

from ..contracts.sol_generator import SolidityGenerator
from ..contracts.yul_vm import run_verifier_gas
from ..merkle.mst import MerkleSumTree
from ..models.mst_inclusion import MstInclusionCircuit
from ..utils import pipeline
from . import _common

USER_INDEX = 0


def main(argv=None) -> dict:
    args = _common.parser(__doc__.splitlines()[0]).parse_args(argv)
    shape = (_common.LEVELS, _common.N_CURRENCIES, _common.N_BYTES)
    artifacts = pipeline.generate_setup_artifacts(_common.K, str(_common.PTAU), *shape,
                                                  device=args.device)
    tree = MerkleSumTree.from_csv(str(_common.CSV_DIR / "entry_16.csv"), args.device)
    circuit = MstInclusionCircuit.init(*shape, tree.generate_proof(USER_INDEX))
    calldata = pipeline.gen_proof_solidity_calldata(artifacts, circuit)
    data = {"proof": calldata.proof, "public_inputs": calldata.public_inputs}
    out = _common.out_dir(args) / "inclusion_proof_solidity_calldata.json"
    out.write_text(json.dumps(data))
    print(f"wrote {out}")

    source = SolidityGenerator(artifacts.params, artifacts.vk, 2 + _common.N_CURRENCIES).render()
    ok, gas = run_verifier_gas(source, bytes.fromhex(calldata.proof[2:]),
                               [int(v, 16) for v in calldata.public_inputs])
    print(f"generated InclusionVerifier accepts the proof: {ok}")
    print(f"Gas cost of verifying the inclusion proof: {gas} (VM estimate)")
    if not ok:
        raise SystemExit("the generated verifier rejected the proof")
    return data


if __name__ == "__main__":
    main()
