"""Write tests/fixtures_torch_criterion.json: the JAX package's proofs at the
criterion and north-star configs and its downsized ceremony bases, against
which the PyTorch port is held byte for byte.

Runs only the JAX package, on the CPU, and edits nothing in it:

    JAX_PLATFORMS=cpu python scripts/make_torch_criterion_fixtures.py [a,b,c]

Parts (a and b by default; the file keeps the entries of parts not rerun):

- ``criterion`` (a): the witness ``synthetic_merkle_proof(20, 1,
  Entry("dxGaEAii", [11888]))`` (seed 0; LEVELS=20, N_BYTES=8, k=13) with
  ``ParamsKZG.setup(13)`` and the default BlindingRng: its instances, the
  Keccak proof of ``pipeline.gen_proof_solidity_calldata`` (default
  vk_digest) and the Blake2b proof of ``pipeline.full_prover``.
- ``downsize`` (b): tests/fixtures_ptau_hermez-raw-11 downsized to k=10 by
  ``ParamsKZG.downsize``: the sha256 of its 1024 ``g_lagrange`` points as
  raw bytes (``g1_to_raw_bytes``) and the count.
- ``northstar`` (c): the same two proofs of ``synthetic_merkle_proof(16, 2,
  Entry("dxGaEAii", [11888, 41163]))`` at k=17 with ``ParamsKZG.setup(17)``.

Run times, JAX 0.9.0 on the CPU of an 8-core x86 host with 62 GB (one run
each): (a) 282.8 s, (b) 255.7 s. (c) did not finish there: after about 27
minutes (keygen done) the first commitment of the proof asked XLA for an
86.7 GB buffer and failed with out-of-memory, so the fixture has no
north-star entry.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from circuits_halo2_tpu.merkle.mst import Entry, synthetic_merkle_proof  # noqa: E402
from circuits_halo2_tpu.models.keygen import keygen  # noqa: E402
from circuits_halo2_tpu.models.mst_inclusion import MstInclusionCircuit, compile_circuit  # noqa: E402
from circuits_halo2_tpu.ops import curve as C  # noqa: E402
from circuits_halo2_tpu.utils import pipeline  # noqa: E402
from circuits_halo2_tpu.utils.srs import ParamsKZG  # noqa: E402

TESTS = ROOT / "tests"
OUT = TESTS / "fixtures_torch_criterion.json"
USER = "dxGaEAii"
CRITERION = (20, [11888], 8, 13)  # LEVELS, balances, N_BYTES, k
NORTHSTAR = (16, [11888, 41163], 8, 17)


def proofs(levels: int, balances: list[int], n_bytes: int, k: int) -> dict:
    """Setup, keygen and both transcripts' proofs of the synthetic witness."""
    ncur = len(balances)
    params = ParamsKZG.setup(k)
    _, cs, config, asn = compile_circuit(levels, ncur, n_bytes, k)
    vk, pk = keygen(params, cs, asn)
    art = pipeline.SetupArtifacts(params, pk, vk, cs, config, (levels, ncur, n_bytes))
    circuit = MstInclusionCircuit.init(
        levels, ncur, n_bytes, synthetic_merkle_proof(levels, ncur, Entry(USER, balances)))
    instances = circuit.instances()
    keccak = pipeline.gen_proof_solidity_calldata(art, circuit)
    blake = pipeline.full_prover(art, circuit, instances)
    assert pipeline.full_verifier(art, blake, instances)
    return {
        "user": USER, "balances": balances, "levels": levels, "n_currencies": ncur,
        "n_bytes": n_bytes, "k": k, "seed": 0,
        "instances": [[hex(v) for v in col] for col in instances],
        "keccak_proof": keccak.proof[2:],
        "blake2b_proof": blake.hex(),
    }


def downsized() -> dict:
    params = ParamsKZG.read(str(TESTS / "fixtures_ptau_hermez-raw-11")).downsize(10)
    raw = b"".join(C.g1_to_raw_bytes(p) for p in params.g_lagrange)
    return {"ptau": "fixtures_ptau_hermez-raw-11", "k": 10, "count": len(params.g_lagrange),
            "g_lagrange_sha256": hashlib.sha256(raw).hexdigest()}


PARTS = {"a": ("criterion", lambda: proofs(*CRITERION)),
         "b": ("downsize", downsized),
         "c": ("northstar", lambda: proofs(*NORTHSTAR))}


def main(parts: str) -> None:
    fixture = json.loads(OUT.read_text()) if OUT.exists() else {}
    for p in parts.split(","):
        name, fn = PARTS[p]
        t0 = time.perf_counter()
        fixture[name] = fn()
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
        OUT.write_text(json.dumps(fixture, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "a,b")
