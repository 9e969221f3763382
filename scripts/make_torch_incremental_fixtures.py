"""Write tests/fixtures_torch_incremental.json: the JAX package's proofs of
the incremental inclusion chain (per-round step proofs chained by public
inputs) and of the chained SNARK (N rounds in one proof), against which the
PyTorch port is held byte for byte.

Runs only the JAX package, on the CPU, and edits nothing in it:

    JAX_PLATFORMS=cpu python scripts/make_torch_incremental_fixtures.py [a,b,c]

Parts (all three by default; the file keeps the entries of parts not rerun):

- ``steps`` (a): ``generate_incremental_artifacts(11,
  tests/fixtures_ptau_hermez-raw-11, 4, 2, 8)``: the VK's fixed and
  permutation commitments; then ``prove_chain`` over
  ``tests/fixtures_csv/states/entry_16_{1,2,3}.csv`` for user 0: the three
  Blake2b step proofs, their instances and the state trajectories.
- ``snark`` (b): ``generate_chained_artifacts(13, None, 4, 2, 8, nsteps=3)``
  (``ParamsKZG.setup(13)``) and ``prove_chain_snark`` over the same three
  rounds for user 0: the proof, its instances, and each round's root and the
  user's leaf hash (``verify_chain_snark``'s expected values).
- ``criterion`` (c): the criterion width (LEVELS=20, 1 currency, N_BYTES=8).
  Three synthetic rounds ``synthetic_merkle_proof(20, 1, Entry("dxGaEAii",
  [11888]), seed=s)`` for s = 1, 2, 3, chained from state (0, 0) by
  ``IncrementalMstInclusionCircuit.init_step``: the three step proofs at
  k=13 (``generate_incremental_artifacts(13, None, 20, 1, 8)``) and the
  ``ChainedMstInclusionCircuit.init_chain`` proof of the same rounds at k=14
  (``generate_chained_artifacts(14, None, 20, 1, 8, nsteps=3)``), with every
  instance and the rounds' roots and leaf hashes.

Run times, JAX 0.9.0 on the CPU of an 8-core x86 host with 62 GB, one run
each, ``a,b`` in one process and ``c`` in another at the same time: (a)
274.7 s, (b) 343.8 s, (c) 908.8 s ((c) held about 8 GB resident when sampled).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from circuits_halo2_tpu.merkle.mst import (Cryptocurrency, Entry, MerkleSumTree,  # noqa: E402
                                           synthetic_merkle_proof)
from circuits_halo2_tpu.models import incremental as INC  # noqa: E402
from circuits_halo2_tpu.ops import poseidon  # noqa: E402
from circuits_halo2_tpu.utils import pipeline  # noqa: E402

TESTS = ROOT / "tests"
OUT = TESTS / "fixtures_torch_incremental.json"
STATES = [f"fixtures_csv/states/entry_16_{i}.csv" for i in (1, 2, 3)]
PTAU = "fixtures_ptau_hermez-raw-11"
USER = "dxGaEAii"
SEEDS = (1, 2, 3)


def _hex(instances) -> list[list[str]]:
    return [[hex(v) for v in col] for col in instances]


def _points(points) -> list[list[str]]:
    return [[hex(x), hex(y)] for x, y in points]


def round_values(levels: int, ncur: int, user_index: int) -> tuple[list[int], list[int]]:
    """Each entry_16 round's root hash and the user's leaf hash."""
    cryptos = [Cryptocurrency(f"CUR{i}", "NA") for i in range(ncur)]
    roots, leaves = [], []
    for path in STATES:
        tree = MerkleSumTree.from_entries(INC.entries_from_states_csv(str(TESTS / path)), cryptos)
        roots.append(tree.root.hash)
        e = tree.get_entry(user_index)
        leaves.append(poseidon.hash_n([e.hashed_username] + list(e.balances)))
    return roots, leaves


def steps() -> dict:
    art = pipeline.generate_incremental_artifacts(11, str(TESTS / PTAU), 4, 2, 8)
    chain = INC.prove_chain(art, [str(TESTS / p) for p in STATES], 0)
    assert INC.verify_chain(art, chain) and INC.verify_chain_compressed(art, chain)
    return {
        "k": 11, "ptau": PTAU, "levels": 4, "n_currencies": 2, "n_bytes": 8,
        "csvs": STATES, "user_index": 0,
        "fixed_comms": _points(art.vk.fixed_commitments),
        "permutation_comms": _points(art.vk.permutation_commitments),
        "proofs": [s.proof.hex() for s in chain.steps],
        "instances": [_hex(s.instances) for s in chain.steps],
        "user_states": [hex(v) for v in chain.user_states],
        "liab_states": [hex(v) for v in chain.liab_states],
    }


def snark() -> dict:
    art = pipeline.generate_chained_artifacts(13, None, 4, 2, 8, nsteps=3)
    proof, inst = INC.prove_chain_snark(art, [str(TESTS / p) for p in STATES], 0)
    roots, leaves = round_values(4, 2, 0)
    assert INC.verify_chain_snark(art, proof, inst, roots, leaves)
    return {
        "k": 13, "levels": 4, "n_currencies": 2, "n_bytes": 8, "nsteps": 3,
        "csvs": STATES, "user_index": 0, "proof": proof.hex(), "instances": _hex(inst),
        "roots": [hex(v) for v in roots], "leaf_hashes": [hex(v) for v in leaves],
    }


def criterion() -> dict:
    levels, ncur, nbytes = 20, 1, 8
    witnesses = [synthetic_merkle_proof(levels, ncur, Entry(USER, [11888]), seed=s)
                 for s in SEEDS]
    art = pipeline.generate_incremental_artifacts(13, None, levels, ncur, nbytes)
    us, ls = 0, 0
    proofs, instances = [], []
    for mp in witnesses:
        circuit = INC.IncrementalMstInclusionCircuit.init_step(levels, ncur, nbytes, mp, us, ls)
        inst = circuit.instances()
        proof = pipeline.full_prover(art, circuit, inst)
        assert pipeline.full_verifier(art, proof, inst)
        proofs.append(proof.hex())
        instances.append(_hex(inst))
        us, ls = inst[0][2], inst[0][3]
    del art
    chained = pipeline.generate_chained_artifacts(14, None, levels, ncur, nbytes, nsteps=3)
    circuit = INC.ChainedMstInclusionCircuit.init_chain(levels, ncur, nbytes, witnesses)
    inst = circuit.instances()
    chain_proof = pipeline.full_prover(chained, circuit, inst)
    roots = [mp.root.hash for mp in witnesses]
    leaves = [poseidon.hash_n([mp.entry.hashed_username] + list(mp.entry.balances))
              for mp in witnesses]
    assert INC.verify_chain_snark(chained, chain_proof, inst, roots, leaves)
    return {
        "user": USER, "balances": [11888], "levels": levels, "n_currencies": ncur,
        "n_bytes": nbytes, "seeds": list(SEEDS), "step_k": 13, "chain_k": 14,
        "step_proofs": proofs, "step_instances": instances,
        "chain_proof": chain_proof.hex(), "chain_instances": _hex(inst),
        "roots": [hex(v) for v in roots], "leaf_hashes": [hex(v) for v in leaves],
    }


PARTS = {"a": ("steps", steps), "b": ("snark", snark), "c": ("criterion", criterion)}


def main(parts: str) -> None:
    for p in parts.split(","):
        name, fn = PARTS[p]
        t0 = time.perf_counter()
        value = fn()
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
        # reread: another process may have written another part meanwhile
        fixture = json.loads(OUT.read_text()) if OUT.exists() else {}
        fixture[name] = value
        OUT.write_text(json.dumps(fixture, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "a,b,c")
