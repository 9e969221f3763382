"""Write tests/fixtures_torch_proofs.json: the JAX package's entry_16 k=11
inclusion proofs, against which the PyTorch port is held byte for byte.

Runs only the JAX package, on the CPU:

    JAX_PLATFORMS=cpu python scripts/make_torch_fixtures.py

Two proofs of user 0 of tests/fixtures_csv/entry_16.csv (LEVELS=4,
N_CURRENCIES=2, N_BYTES=8) with the hermez-raw-11 SRS and the default
deterministic BlindingRng: the Keccak (EVM) transcript keyed by the
fixture vk_digest, and the Blake2b (native) transcript keyed by the
computed transcript_repr.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from circuits_halo2_tpu.merkle.mst import MerkleSumTree  # noqa: E402
from circuits_halo2_tpu.models.keygen import keygen  # noqa: E402
from circuits_halo2_tpu.models.mst_inclusion import MstInclusionCircuit, compile_circuit  # noqa: E402
from circuits_halo2_tpu.models.prover import prove  # noqa: E402
from circuits_halo2_tpu.models.verifier import verify  # noqa: E402
from circuits_halo2_tpu.utils.srs import ParamsKZG  # noqa: E402
from circuits_halo2_tpu.utils.transcript import Blake2bTranscript, KeccakTranscript  # noqa: E402

TESTS = ROOT / "tests"
LEVELS, N_CURRENCIES, N_BYTES, K = 4, 2, 8, 11


def make() -> dict:
    vk_digest = int(json.loads((TESTS / "fixtures_vk_inclusion.json").read_text())["vk_digest"], 16)
    params = ParamsKZG.read(str(TESTS / "fixtures_ptau_hermez-raw-11"))
    _, cs, config, asn = compile_circuit(LEVELS, N_CURRENCIES, N_BYTES, K)
    vk, pk = keygen(params, cs, asn)
    tree = MerkleSumTree.from_csv(str(TESTS / "fixtures_csv" / "entry_16.csv"))
    circuit = MstInclusionCircuit.init(LEVELS, N_CURRENCIES, N_BYTES, tree.generate_proof(0))
    instances = circuit.instances()
    keccak = prove(params, pk, circuit, config, instances, transcript_cls=KeccakTranscript,
                   vk_digest=vk_digest)
    blake = prove(params, pk, circuit, config, instances, transcript_cls=Blake2bTranscript)
    assert verify(params, vk, instances, keccak, transcript_cls=KeccakTranscript,
                  vk_digest=vk_digest)
    assert verify(params, vk, instances, blake, transcript_cls=Blake2bTranscript)
    return {
        "csv": "fixtures_csv/entry_16.csv",
        "user_index": 0,
        "levels": LEVELS,
        "n_currencies": N_CURRENCIES,
        "n_bytes": N_BYTES,
        "k": K,
        "instances": [[hex(v) for v in col] for col in instances],
        "keccak_vk_digest_proof": keccak.hex(),
        "blake2b_proof": blake.hex(),
    }


if __name__ == "__main__":
    out = TESTS / "fixtures_torch_proofs.json"
    out.write_text(json.dumps(make(), indent=1) + "\n")
    print(f"wrote {out}")
