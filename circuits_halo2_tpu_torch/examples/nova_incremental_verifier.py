"""Incremental inclusion across rounds (``examples/nova_incremental_verifier.py``,
after the reference's ``zk_prover/examples/nova_incremental_verifier.rs``):
an exchange proves user 0's inclusion in the rounds
``states/entry_16_{1,2,3}.csv`` as one verifiable chain, in four layers:

1. the circom-parity witness chain (``merkle/circom_mst``, circom's
   Poseidon): user_state_i = H(user_state_{i-1}, leaf_hash_i),
   liab_state_i = H(liab_state_{i-1}, root_hash_i);
2. the step-proof chain (``models/incremental``) on ``--device``: keygen
   of the step circuit at k=11 on the hermez-raw-11 SRS, one proof per
   round, chained by public inputs, verified step by step and with one
   pairing;
3. Nova NIFS (``models/nova_fold`` over ``merkle/circom_r1cs``): the three
   step R1CS instances folded into one relaxed instance, verified with
   pinned endpoints (host);
4. the Spartan + IPA compression of that accumulator (``models/spartan``,
   host).

Writes the chain's final states, proofs and timings to
``nova_incremental_chain.json`` in ``--out``.

    python -m circuits_halo2_tpu_torch.examples.nova_incremental_verifier [--device cpu] [--out DIR]
"""

import json
import time

from ..merkle import circom_mst as CM
from ..merkle import circom_r1cs as CR
from ..models import incremental as INC
from ..models import nova_fold as NF
from ..models import spartan as SP
from ..utils import pipeline
from . import _common

STATES = [str(_common.CSV_DIR / "states" / f"entry_16_{i}.csv") for i in (1, 2, 3)]
USER_INDEX = 0


def main(argv=None) -> dict:
    args = _common.parser(__doc__.splitlines()[0]).parse_args(argv)
    start = time.perf_counter()
    times = {}

    # 1. circom-parity witness chain
    proofs, user_states, liab_states = CM.state_chain(STATES, USER_INDEX)
    if not all(CM.verify_merkle_proof(p) for p in proofs):
        raise SystemExit("a circom inclusion witness does not verify")
    zn = [user_states[-1], liab_states[-1]]
    print(f"user_state_cur at state 3 (circom chain):        {hex(zn[0])}")
    print(f"liabilities_state_cur at state 3 (circom chain): {hex(zn[1])}")

    # 2. step-proof chain on --device
    t0 = time.perf_counter()
    art = pipeline.generate_incremental_artifacts(
        _common.K, str(_common.PTAU), _common.LEVELS, _common.N_CURRENCIES, _common.N_BYTES,
        device=args.device)
    times["keygen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain = INC.prove_chain(art, STATES, USER_INDEX)
    times["prove_chain_s"] = time.perf_counter() - t0
    print(f"step-circuit keygen {times['keygen_s']:.1f} s; 3 chained step proofs "
          f"{times['prove_chain_s']:.1f} s ({len(chain.steps[0].proof)} bytes each)")
    t0 = time.perf_counter()
    if not (INC.verify_chain(art, chain) and INC.verify_chain_compressed(art, chain)):
        raise SystemExit("the step-proof chain does not verify")
    times["verify_chain_s"] = time.perf_counter() - t0
    print(f"chain verification (per step, then one pairing): {times['verify_chain_s']:.1f} s")
    print(f"user_state_cur at state 3 (proof chain):        {hex(chain.user_states[-1])}")
    print(f"liabilities_state_cur at state 3 (proof chain): {hex(chain.liab_states[-1])}")

    # 3. Nova NIFS: fold the three step R1CS instances into one accumulator
    t0 = time.perf_counter()
    wits, r1cs, si = [], None, (0, 0)
    for p in proofs:
        r1cs_i, w = CR.build_incremental_mst_inclusion(p, si)
        r1cs = r1cs or r1cs_i
        wits.append(w)
        si = (w[1], w[2])  # step_out becomes the next step_in
    # a power of two, as Spartan's IPA needs (the first bases, which the
    # folding commits with, are the same for any count)
    bases = NF.pedersen_bases(SP._next_pow2(max(r1cs.n_wires, len(r1cs.constraints))))
    acc_i, acc_w, steps = NF.fold_chain(r1cs, wits, bases)
    if not NF.verify_chain(r1cs, steps, acc_i, acc_w, bases, z0=[0, 0], zn=zn):
        raise SystemExit("the NIFS accumulator does not verify")
    times["nifs_s"] = time.perf_counter() - t0
    print(f"NIFS: folded {len(wits)} steps ({len(r1cs.constraints)} constraints each) into "
          f"one relaxed instance; verified in {times['nifs_s']:.1f} s total")

    # 4. Spartan + IPA compression of the accumulator
    t0 = time.perf_counter()
    cproof = SP.compress(r1cs, acc_i, acc_w, bases)
    times["spartan_prove_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not SP.verify_chain_compressed(r1cs, steps, acc_i, cproof, bases, n_w=len(acc_w.w),
                                      z0=[0, 0], zn=zn):
        raise SystemExit("the compressed proof does not verify")
    times["spartan_verify_s"] = time.perf_counter() - t0
    wit_bytes = 32 * (len(acc_w.w) + len(acc_w.e))
    print(f"CompressedSNARK: {cproof.size_bytes()} bytes (vs {wit_bytes}-byte witness reveal), "
          f"prove {times['spartan_prove_s']:.1f} s / verify {times['spartan_verify_s']:.1f} s")
    times["total_s"] = time.perf_counter() - start
    print(f"all four layers: {times['total_s']:.1f} s on {args.device}")

    data = {"device": args.device, "circom_states": [hex(v) for v in zn],
            "user_states": [hex(v) for v in chain.user_states],
            "liab_states": [hex(v) for v in chain.liab_states],
            "step_proofs": [s.proof.hex() for s in chain.steps],
            "compressed_proof_bytes": cproof.size_bytes(), "times": times}
    out = _common.out_dir(args) / "nova_incremental_chain.json"
    out.write_text(json.dumps(data, indent=1))
    print(f"wrote {out}")
    return data


if __name__ == "__main__":
    main()
