"""Write tests/fixtures_torch_contracts.json: the JAX package's generated
Solidity verifier for the entry_16 k=11 VK, as its sha256 and length,
against which the PyTorch port's generator is held.

Runs only the JAX package, on the CPU:

    JAX_PLATFORMS=cpu python scripts/make_torch_contract_fixtures.py

Keygen of the MstInclusion circuit (LEVELS=4, N_CURRENCIES=2, N_BYTES=8,
k=11) with the hermez-raw-11 SRS, then ``SolidityGenerator(params, vk,
4).render()`` with the VK's own transcript digest. The source's header
line names the generating module, so the fixture keeps that line too.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from circuits_halo2_tpu.contracts.sol_generator import SolidityGenerator  # noqa: E402
from circuits_halo2_tpu.models.keygen import keygen  # noqa: E402
from circuits_halo2_tpu.models.mst_inclusion import compile_circuit  # noqa: E402
from circuits_halo2_tpu.utils.srs import ParamsKZG  # noqa: E402

TESTS = ROOT / "tests"
OUT = TESTS / "fixtures_torch_contracts.json"
LEVELS, N_CURRENCIES, N_BYTES, K = 4, 2, 8, 11
HEADER_PREFIX = "// Generated by "


def make() -> dict:
    params = ParamsKZG.read(str(TESTS / "fixtures_ptau_hermez-raw-11"))
    _, cs, _, asn = compile_circuit(LEVELS, N_CURRENCIES, N_BYTES, K)
    vk, _ = keygen(params, cs, asn)
    source = SolidityGenerator(params, vk, 2 + N_CURRENCIES).render()
    header = [line for line in source.splitlines() if line.startswith(HEADER_PREFIX)]
    assert len(header) == 1, header
    return {
        "levels": LEVELS,
        "n_currencies": N_CURRENCIES,
        "n_bytes": N_BYTES,
        "k": K,
        "num_instances": 2 + N_CURRENCIES,
        "transcript_repr": hex(vk.transcript_repr),
        "header_line": header[0],
        "verifier_sha256": hashlib.sha256(source.encode()).hexdigest(),
        "verifier_length": len(source),
    }


if __name__ == "__main__":
    fix = make()
    OUT.write_text(json.dumps(fix, indent=1) + "\n")
    print(f"wrote {OUT}: {fix['verifier_length']} characters, sha256 {fix['verifier_sha256']}")
