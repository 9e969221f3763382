"""The port's incremental inclusion (``models/incremental``) and its host
recursion side (``merkle/circom_mst``, ``merkle/circom_r1cs``,
``ops/poseidon_circom``, ``models/nova_fold``) against the JAX package's.

- The default cases of ``tests/test_incremental.py`` through the port, each
  output equal to the JAX package's on the same input: circom Poseidon
  vectors, circom proofs and state chains, the step circuit under the mock
  prover, the step R1CS and its witness, the ``.r1cs``/``.wtns`` files byte
  for byte, and the NIFS accumulators.
- The entry_16 step chain at k=11 on the CPU equal to the JAX package's
  bytes (tests/fixtures_torch_incremental.json, part ``steps``), with both
  verifiers and their rejections; the chained SNARK at k=13 against part
  ``snark`` (slow).
- JAX-side objects carried by ``convert`` and checked by the port: the
  fixture's step proofs, the JAX step circuit's proving key, and a
  JAX-folded accumulator.
- The recursion example on the CPU, its keygen and step chain those of the
  module's fixture (the card runs it whole in ``chip_smoke.py``).

Exact throughout.
"""

import copy
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from circuits_halo2_tpu.merkle import circom_mst as JCM
from circuits_halo2_tpu.merkle import circom_r1cs as JR
from circuits_halo2_tpu.models import incremental as JINC
from circuits_halo2_tpu.models import nova_fold as JNF
from circuits_halo2_tpu.models.keygen import keygen as jax_keygen
from circuits_halo2_tpu.models.mock_prover import MockProver as JaxMockProver
from circuits_halo2_tpu.merkle.mst import Cryptocurrency as JaxCrypto
from circuits_halo2_tpu.merkle.mst import MerkleSumTree as JaxTree
from circuits_halo2_tpu.ops import poseidon_circom as JPC
from circuits_halo2_tpu.utils.srs import ParamsKZG as JaxParams
from circuits_halo2_tpu_torch import convert
from circuits_halo2_tpu_torch.examples import nova_incremental_verifier as EX
from circuits_halo2_tpu_torch.merkle import circom_mst as CM
from circuits_halo2_tpu_torch.merkle import circom_r1cs as R
from circuits_halo2_tpu_torch.merkle.mst import Cryptocurrency, MerkleSumTree
from circuits_halo2_tpu_torch.models import incremental as INC
from circuits_halo2_tpu_torch.models import nova_fold as NF
from circuits_halo2_tpu_torch.models.mock_prover import MockProver
from circuits_halo2_tpu_torch.ops import poseidon
from circuits_halo2_tpu_torch.ops import poseidon_circom as PC
from circuits_halo2_tpu_torch.utils import pipeline

torch.set_num_threads(2)

HERE = Path(__file__).parent
STATES = [str(HERE / "fixtures_csv" / "states" / f"entry_16_{i}.csv") for i in (1, 2, 3)]
SRS = str(HERE / "fixtures_ptau_hermez-raw-11")
FIX = json.loads((HERE / "fixtures_torch_incremental.json").read_text())


def _ints(rows):
    return [[int(v, 16) for v in col] for col in rows]


def _asdict(x):
    return dataclasses.asdict(x)


# -- the host side: circom witness chain, R1CS, NIFS ------------------------


@pytest.mark.parametrize("inputs, want", [
    ([1, 2], 7853200120776062878684798364095072458815029376092732009249414926327459813530),
    ([1, 2, 3, 4],
     18821383157269793795438455681495246036402687001665670618754263018637548127333),
])
def test_circom_poseidon_known_vectors(inputs, want):
    assert PC.hash_n(inputs) == JPC.hash_n(inputs) == want


def test_circom_mst_proof_roundtrip():
    proof = CM.build_merkle_proof(STATES[0], 0)
    assert _asdict(proof) == _asdict(JCM.build_merkle_proof(STATES[0], 0))
    assert len(proof.path_indices) == 4
    assert CM.verify_merkle_proof(proof)
    entries = CM.parse_states_csv(STATES[0])
    assert proof.root.balances == [sum(b[i] for _, b in entries) for i in range(2)]
    bad = CM.build_merkle_proof(STATES[0], 1)
    assert _asdict(bad) == _asdict(JCM.build_merkle_proof(STATES[0], 1))
    bad.root = proof.root
    assert CM.verify_merkle_proof(bad) == (
        CM.build_merkle_proof(STATES[0], 1).root.hash == proof.root.hash)


def test_state_chain_structure():
    proofs, user_states, liab_states = CM.state_chain(STATES, 0)
    jproofs, juser, jliab = JCM.state_chain(STATES, 0)
    assert [_asdict(p) for p in proofs] == [_asdict(p) for p in jproofs]
    assert (user_states, liab_states) == (juser, jliab)
    assert len(proofs) == 3 and len(user_states) == 4 and len(liab_states) == 4
    assert user_states[0] == 0 and liab_states[0] == 0
    us = ls = 0
    for p in proofs:
        us = CM.user_state_next(us, p.username, p.user_balances)
        ls = CM.liabilities_state_next(ls, p.root.hash)
    assert (us, ls) == (user_states[-1], liab_states[-1])
    assert len(set(user_states)) == 4


def test_incremental_circuit_mock():
    """Step circuit satisfiability and a wrong-state negative under both
    packages' mock provers, on the same instances."""
    cryptos = [Cryptocurrency("ETH", "ETH"), Cryptocurrency("BTC", "BTC")]
    tree = MerkleSumTree.from_entries(INC.entries_from_states_csv(STATES[0]), cryptos, "cpu")
    circ = INC.IncrementalMstInclusionCircuit.init_step(4, 2, 8, tree.generate_proof(0), 7, 9)
    jcryptos = [JaxCrypto("ETH", "ETH"), JaxCrypto("BTC", "BTC")]
    jtree = JaxTree.from_entries(JINC.entries_from_states_csv(STATES[0]), jcryptos)
    jcirc = JINC.IncrementalMstInclusionCircuit.init_step(4, 2, 8, jtree.generate_proof(0), 7, 9)
    inst = circ.instances()
    assert inst == jcirc.instances()
    assert MockProver(11, circ, inst).verify() == []
    bad = [list(inst[0])]
    bad[0][2] = (bad[0][2] + 1) % (1 << 64)
    failures = MockProver(11, circ, bad).verify()
    assert failures, "tampered state must fail"
    assert len(failures) == len(JaxMockProver(11, jcirc, bad).verify())


def test_r1cs_step_circuit_satisfied():
    proof = CM.build_merkle_proof(STATES[0], 0)
    r1cs, wit = R.build_incremental_mst_inclusion(proof, (0, 0))
    jr1cs, jwit = JR.build_incremental_mst_inclusion(JCM.build_merkle_proof(STATES[0], 0), (0, 0))
    assert r1cs.constraints == jr1cs.constraints and wit == jwit
    assert (r1cs.n_wires, r1cs.n_pub_out, r1cs.n_pub_in, r1cs.n_prv_in) == (
        jr1cs.n_wires, jr1cs.n_pub_out, jr1cs.n_pub_in, jr1cs.n_prv_in)
    assert r1cs.check(wit)
    assert wit[1] == CM.user_state_next(0, proof.username, proof.user_balances)
    assert wit[2] == CM.liabilities_state_next(0, proof.root.hash)
    assert wit[3] == 0 and wit[4] == 0

    def n_sbox(t):
        return 3 * (8 * t + R.PC.N_ROUNDS_P[t - 2])

    poseidon_c = n_sbox(4) + 2 * n_sbox(3) + 4 * n_sbox(7)
    bits_c = (4 * 2 * 2 + 2) * (112 + 1)
    swap_c = 4 * (1 + 2 + 2 * 2)
    assert len(r1cs.constraints) == poseidon_c + bits_c + swap_c + 2
    bad = list(wit)
    bad[5 + 2 + 4 + 8] ^= 1
    assert not r1cs.check(bad)
    bad2 = list(wit)
    bad2[len(wit) // 2] = (bad2[len(wit) // 2] + 1) % R.P
    assert not r1cs.check(bad2)


def test_r1cs_wtns_binary_roundtrip(tmp_path):
    """The port writes the same ``.r1cs``/``.wtns`` bytes as the JAX
    package, and reads them back to the identical system."""
    si = (123456789, 987654321)
    r1cs, wit = R.build_incremental_mst_inclusion(CM.build_merkle_proof(STATES[1], 2), si)
    jr1cs, jwit = JR.build_incremental_mst_inclusion(JCM.build_merkle_proof(STATES[1], 2), si)
    rp, wp = tmp_path / "step.r1cs", tmp_path / "step.wtns"
    jrp, jwp = tmp_path / "jax.r1cs", tmp_path / "jax.wtns"
    R.write_r1cs(r1cs, str(rp))
    R.write_wtns(wit, str(wp))
    JR.write_r1cs(jr1cs, str(jrp))
    JR.write_wtns(jwit, str(jwp))
    assert rp.read_bytes() == jrp.read_bytes() and wp.read_bytes() == jwp.read_bytes()
    r2, w2 = R.read_r1cs(str(rp)), R.read_wtns(str(wp))
    assert (r2.n_wires, r2.n_pub_out, r2.n_pub_in, r2.n_prv_in) == (r1cs.n_wires, 2, 2, 19)
    assert r2.constraints == r1cs.constraints
    assert w2 == wit
    assert r2.check(w2)


def _toy_r1cs(mod):
    """out = x^3 + x over wires [1, out, x, x2, x3] (pub out, pub in)."""
    cons = [
        ({2: 1}, {2: 1}, {3: 1}),
        ({3: 1}, {2: 1}, {4: 1}),
        ({4: 1, 2: 1, 1: R.P - 1}, {0: 1}, {}),
    ]
    return mod.R1CS(5, 1, 1, 0, cons)


def _toy_witness(x):
    return [1, (x**3 + x) % R.P, x, x * x % R.P, x**3 % R.P]


def _toy_chain():
    xs = [3]
    for _ in range(2):
        xs.append((xs[-1] ** 3 + xs[-1]) % R.P)
    return xs, [_toy_witness(x) for x in xs]


def test_nova_nifs_fold_chain():
    r1cs = _toy_r1cs(R)
    bases = NF.pedersen_bases(max(5, len(r1cs.constraints)))
    assert bases == JNF.pedersen_bases(max(5, len(r1cs.constraints)))
    xs, wits = _toy_chain()
    for w in wits:
        assert r1cs.check(w)
    z0, zn = [xs[0]], [(xs[-1] ** 3 + xs[-1]) % R.P]
    acc_i, acc_w, steps = NF.fold_chain(r1cs, wits, bases)
    jacc_i, jacc_w, jsteps = JNF.fold_chain(_toy_r1cs(JR), wits, bases)
    assert (_asdict(acc_i), _asdict(acc_w)) == (_asdict(jacc_i), _asdict(jacc_w))
    assert [(_asdict(i), t) for i, t in steps] == [(_asdict(i), t) for i, t in jsteps]
    assert any(acc_w.e) and acc_i.u != 1
    assert NF.relaxed_check(r1cs, acc_i, acc_w, bases)
    assert NF.verify_chain(r1cs, steps, acc_i, acc_w, bases, z0=z0, zn=zn)
    bad_w = NF.RelaxedWitness(list(acc_w.w), list(acc_w.e))
    bad_w.e[0] = (bad_w.e[0] + 1) % R.P
    assert not NF.verify_chain(r1cs, steps, acc_i, bad_w, bases)
    bad_steps = list(steps)
    bad_steps[1] = (bad_steps[1][0], NF.C.G1_GEN)
    assert not NF.verify_chain(r1cs, bad_steps, acc_i, acc_w, bases)
    assert not NF.verify_chain(r1cs, steps, acc_i, acc_w, bases, z0=[xs[0] + 1], zn=zn)
    assert not NF.verify_chain(r1cs, steps, acc_i, acc_w, bases, z0=z0, zn=[zn[0] + 1])
    ai, aw, st = NF.fold_chain(r1cs, [_toy_witness(x) for x in (3, 5)], bases)
    assert not NF.verify_chain(r1cs, st, ai, aw, bases)
    forged = NF.RelaxedInstance(steps[1][0].com_w, NF.C.G1_GEN, steps[1][0].u,
                                list(steps[1][0].x))
    assert not NF.verify_chain(r1cs, [steps[0], (forged, steps[1][1]), steps[2]],
                               acc_i, acc_w, bases)
    bogus = _toy_witness(3)
    bogus[1] = (bogus[1] + 1) % R.P
    acc_i2, acc_w2, _ = NF.fold_chain(r1cs, [wits[0], bogus], bases)
    assert not NF.relaxed_check(r1cs, acc_i2, acc_w2, bases)


def test_jax_folded_accumulator_verifies_in_the_port():
    """A JAX-folded accumulator and its step records, carried by
    ``convert``, pass the port's ``nova_fold.verify_chain``; a tampered
    one fails."""
    xs, wits = _toy_chain()
    bases = JNF.pedersen_bases(5)
    jacc_i, jacc_w, jsteps = JNF.fold_chain(_toy_r1cs(JR), wits, bases)
    acc_i = convert.relaxed_instance_from_jax(jacc_i)
    acc_w = convert.relaxed_witness_from_jax(jacc_w)
    steps = convert.nifs_steps_from_jax(jsteps)
    assert type(acc_i) is NF.RelaxedInstance and type(steps[1][0]) is NF.RelaxedInstance
    zn = [(xs[-1] ** 3 + xs[-1]) % R.P]
    assert NF.verify_chain(_toy_r1cs(R), steps, acc_i, acc_w, bases, z0=[xs[0]], zn=zn)
    acc_w.w[0] = (acc_w.w[0] + 1) % R.P
    assert not NF.verify_chain(_toy_r1cs(R), steps, acc_i, acc_w, bases)


# -- the step-proof chain at k=11 on the CPU --------------------------------

STEPS = FIX["steps"]
SHAPE = (STEPS["levels"], STEPS["n_currencies"], STEPS["n_bytes"])


@pytest.fixture(scope="module")
def chain():
    """One keygen and three step proofs at k=11 on the CPU, shared by the
    cases below."""
    art = pipeline.generate_incremental_artifacts(STEPS["k"], SRS, *SHAPE, device="cpu")
    return art, INC.prove_chain(art, STATES, STEPS["user_index"])


def test_step_chain_equals_jax_bytes(chain):
    art, proof = chain
    assert art.vk.fixed_commitments == [tuple(p) for p in _ints(STEPS["fixed_comms"])]
    assert art.vk.permutation_commitments == [
        tuple(p) for p in _ints(STEPS["permutation_comms"])]
    assert [s.proof.hex() for s in proof.steps] == STEPS["proofs"]
    assert [s.instances for s in proof.steps] == [_ints(i) for i in STEPS["instances"]]
    assert proof.user_states == [int(v, 16) for v in STEPS["user_states"]]
    assert proof.liab_states == [int(v, 16) for v in STEPS["liab_states"]]


def test_step_chain_verifies_and_rejects(chain):
    art, proof = chain
    assert INC.verify_chain(art, proof)
    assert INC.verify_chain_compressed(art, proof)
    bad = copy.deepcopy(proof)
    flipped = bytearray(bad.steps[1].proof)
    flipped[100] ^= 1
    bad.steps[1] = INC.IncrementalStep(bytes(flipped), bad.steps[1].instances)
    assert not INC.verify_chain(art, bad)
    assert not INC.verify_chain_compressed(art, bad)
    broken = copy.deepcopy(proof)
    broken.steps[1].instances[0][0] ^= 1
    assert not INC.verify_chain(art, broken)
    assert not INC.verify_chain_compressed(art, broken)


def test_jax_step_proofs_verify_in_the_port(chain):
    """The fixture's proofs as the JAX package's ``IncrementalChainProof``,
    carried by ``convert``, pass the port's verifiers."""
    art, _ = chain
    jsteps = [JINC.IncrementalStep(bytes.fromhex(p), _ints(i))
              for p, i in zip(STEPS["proofs"], STEPS["instances"])]
    jchain = JINC.IncrementalChainProof(jsteps, [int(v, 16) for v in STEPS["user_states"]],
                                        [int(v, 16) for v in STEPS["liab_states"]])
    ours = convert.incremental_chain_from_jax(jchain)
    assert type(ours) is INC.IncrementalChainProof and type(ours.steps[0]) is INC.IncrementalStep
    assert INC.verify_chain(art, ours) and INC.verify_chain_compressed(art, ours)
    ours.liab_states[-1] ^= 1
    assert not INC.verify_chain(art, ours)


def test_jax_step_key_carried_into_the_port(chain):
    """The JAX package's step-circuit proving key, carried by
    ``proving_key_from_jax`` beside the port's own constraint system,
    equals the port's key and proves round 1 to the fixture's bytes."""
    art, _ = chain
    jparams = JaxParams.read(SRS)
    _, jcs, _, jasn = JINC.compile_incremental_circuit(*SHAPE, STEPS["k"])
    _, jpk = jax_keygen(jparams, jcs, jasn)
    _, cs, config, _ = INC.compile_incremental_circuit(*SHAPE, STEPS["k"])
    pk = convert.proving_key_from_jax(jpk, cs)
    assert pk.vk.cs is cs
    assert pk.vk.fixed_commitments == art.vk.fixed_commitments
    assert pk.vk.permutation_commitments == art.vk.permutation_commitments
    assert pk.vk.transcript_repr == art.vk.transcript_repr
    assert pk.l_active_row == art.pk.l_active_row
    carried = pipeline.SetupArtifacts(art.params, pk, pk.vk, cs, config, SHAPE,
                                      torch.device("cpu"))
    tree = MerkleSumTree.from_entries(INC.entries_from_states_csv(STATES[0]),
                                      [Cryptocurrency(f"CUR{i}", "NA") for i in range(2)], "cpu")
    circuit = INC.IncrementalMstInclusionCircuit.init_step(*SHAPE, tree.generate_proof(0), 0, 0)
    assert pipeline.full_prover(carried, circuit, circuit.instances()).hex() == STEPS["proofs"][0]


def test_example_on_the_cpu(chain, tmp_path, monkeypatch):
    """The example with ``--device cpu``: it asks for the fixture's key and
    chain (handed the module's, already proved), its circom-parity states
    equal the JAX package's circom chain, and its NIFS accumulator
    compresses through Spartan and verifies."""
    art, proof = chain
    calls = []

    def keygen(*args, **kwargs):
        calls.append(("keygen", args, kwargs))
        return art

    def prove(*args):
        calls.append(("prove_chain", args))
        return proof

    monkeypatch.setattr(pipeline, "generate_incremental_artifacts", keygen)
    monkeypatch.setattr(INC, "prove_chain", prove)
    data = EX.main(["--device", "cpu", "--out", str(tmp_path)])
    (_, (k, srs, *shape), kwargs), (_, (got_art, csvs, user)) = calls
    assert (k, Path(srs).resolve(), tuple(shape), kwargs) == (
        STEPS["k"], Path(SRS).resolve(), SHAPE, {"device": "cpu"})
    assert got_art is art and user == STEPS["user_index"]
    assert [Path(c).resolve() for c in csvs] == [Path(c).resolve() for c in STATES]
    assert json.loads((tmp_path / "nova_incremental_chain.json").read_text()) == data
    assert data["step_proofs"] == STEPS["proofs"]
    _, user_states, liab_states = JCM.state_chain(STATES, STEPS["user_index"])
    assert data["circom_states"] == [hex(user_states[-1]), hex(liab_states[-1])]
    assert 0 < data["compressed_proof_bytes"] < 32 * 8192


# -- the chained SNARK at k=13 on the CPU -----------------------------------


@pytest.mark.slow
def test_chain_snark_equals_jax_bytes():
    snark = FIX["snark"]
    shape = (snark["levels"], snark["n_currencies"], snark["n_bytes"])
    art = pipeline.generate_chained_artifacts(snark["k"], None, *shape, nsteps=snark["nsteps"],
                                              device="cpu")
    proof, inst = INC.prove_chain_snark(art, STATES, snark["user_index"])
    assert proof.hex() == snark["proof"] and len(proof) == 1632
    assert inst == _ints(snark["instances"])
    roots = [int(v, 16) for v in snark["roots"]]
    leaves = [int(v, 16) for v in snark["leaf_hashes"]]
    cryptos = [Cryptocurrency(f"CUR{i}", "NA") for i in range(shape[1])]
    for path, root, leaf in zip(STATES, roots, leaves):
        tree = MerkleSumTree.from_entries(INC.entries_from_states_csv(path), cryptos, "cpu")
        e = tree.get_entry(snark["user_index"])
        assert (tree.root.hash, poseidon.hash_n([e.hashed_username] + e.balances)) == (root, leaf)
    assert INC.verify_chain_snark(art, proof, inst, expected_roots=roots,
                                  expected_leaf_hashes=leaves)
    assert not INC.verify_chain_snark(art, proof, inst, expected_roots=roots[:2])
    bad = proof[:200] + bytes([proof[200] ^ 1]) + proof[201:]
    assert not INC.verify_chain_snark(art, bad, inst, expected_roots=roots)
