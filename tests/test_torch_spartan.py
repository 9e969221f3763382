"""The port's Spartan + IPA compression (``models/spartan``, host code whose
MSM goes to the port's native Pippenger) against the JAX package's: the
default cases of ``tests/test_spartan.py`` on the toy IVC chain, each
compressed proof equal to the JAX package's on the same folded inputs
(every field, the IPA rounds included). Exact."""

import copy
import dataclasses

from circuits_halo2_tpu.merkle.circom_r1cs import R1CS as JR1CS
from circuits_halo2_tpu.models import nova_fold as JNF
from circuits_halo2_tpu.models import spartan as JSP
from circuits_halo2_tpu_torch.merkle.circom_r1cs import P, R1CS
from circuits_halo2_tpu_torch.models import nova_fold as NF
from circuits_halo2_tpu_torch.models import spartan as SP


def _toy(cls):
    """out = x^3 + x over wires [1, out, x, x2, x3] (pub out, pub in)."""
    cons = [
        ({2: 1}, {2: 1}, {3: 1}),
        ({3: 1}, {2: 1}, {4: 1}),
        ({4: 1, 2: 1, 1: P - 1}, {0: 1}, {}),
    ]
    return cls(5, 1, 1, 0, cons)


def _toy_witness(x):
    return [1, (x**3 + x) % P, x, x * x % P, x**3 % P]


def _chain_witnesses(n_steps):
    xs = [3]
    for _ in range(n_steps - 1):
        xs.append((xs[-1] ** 3 + xs[-1]) % P)
    return xs, [_toy_witness(x) for x in xs]


def _fold_toy_chain(n_steps=3):
    """The port's fold of the toy chain, and the JAX package's of the same."""
    xs, wits = _chain_witnesses(n_steps)
    r1cs, bases = _toy(R1CS), NF.pedersen_bases(8)
    acc_i, acc_w, steps = NF.fold_chain(r1cs, wits, bases)
    jr1cs, jbases = _toy(JR1CS), JNF.pedersen_bases(8)
    jacc_i, jacc_w, _ = JNF.fold_chain(jr1cs, wits, jbases)
    assert bases == jbases
    assert dataclasses.asdict(acc_i) == dataclasses.asdict(jacc_i)
    assert dataclasses.asdict(acc_w) == dataclasses.asdict(jacc_w)
    z0, zn = [xs[0]], [(xs[-1] ** 3 + xs[-1]) % P]
    return (r1cs, bases, acc_i, acc_w, steps, z0, zn), (jr1cs, jbases, jacc_i, jacc_w)


def _compress_both(ours, theirs):
    r1cs, bases, acc_i, acc_w = ours[:4]
    jr1cs, jbases, jacc_i, jacc_w = theirs
    proof = SP.compress(r1cs, acc_i, acc_w, bases)
    jproof = JSP.compress(jr1cs, jacc_i, jacc_w, jbases)
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof)
    assert proof.size_bytes() == jproof.size_bytes()
    return proof


def test_compress_roundtrip():
    ours, theirs = _fold_toy_chain()
    r1cs, bases, acc_i, acc_w, steps, z0, zn = ours
    assert any(acc_w.e) and acc_i.u != 1
    proof = _compress_both(ours, theirs)
    assert SP.verify_compressed(r1cs, acc_i, proof, bases)
    assert SP.verify_chain_compressed(r1cs, steps, acc_i, proof, bases, n_w=len(acc_w.w),
                                      z0=z0, zn=zn)
    assert proof.size_bytes() > 0
    assert len(proof.ipa_w.lr) == 1 and len(proof.ipa_e.lr) == 2


def test_compress_size_independent_of_chain_length():
    sizes = []
    for n in (2, 5):
        ours, theirs = _fold_toy_chain(n)
        proof = _compress_both(ours, theirs)
        assert SP.verify_compressed(ours[0], ours[2], proof, ours[1])
        sizes.append(proof.size_bytes())
    assert sizes[0] == sizes[1]


def test_compress_rejects_tampering():
    ours, theirs = _fold_toy_chain()
    r1cs, bases, acc_i, acc_w, steps, z0, zn = ours
    proof = _compress_both(ours, theirs)
    for fld in ("v_a", "v_b", "v_c", "v_e", "w_eval"):
        bad = copy.deepcopy(proof)
        setattr(bad, fld, (getattr(bad, fld) + 1) % P)
        assert not SP.verify_compressed(r1cs, acc_i, bad, bases), fld
    bad = copy.deepcopy(proof)
    bad.sc1_polys[0][2] = (bad.sc1_polys[0][2] + 1) % P
    assert not SP.verify_compressed(r1cs, acc_i, bad, bases)
    bad = copy.deepcopy(proof)
    bad.sc2_polys[0][1] = (bad.sc2_polys[0][1] + 1) % P
    assert not SP.verify_compressed(r1cs, acc_i, bad, bases)
    bad = copy.deepcopy(proof)
    bad.ipa_w.a_final = (bad.ipa_w.a_final + 1) % P
    assert not SP.verify_compressed(r1cs, acc_i, bad, bases)
    bad = copy.deepcopy(proof)
    bad.ipa_e.lr[0] = (bad.ipa_e.lr[0][1], bad.ipa_e.lr[0][0])
    assert not SP.verify_compressed(r1cs, acc_i, bad, bases)
    other = NF.RelaxedInstance(acc_i.com_w, acc_i.com_e, acc_i.u,
                               [(v + 1) % P for v in acc_i.x])
    assert not SP.verify_compressed(r1cs, other, proof, bases)
    assert not SP.verify_chain_compressed(r1cs, steps, acc_i, proof, bases, n_w=len(acc_w.w),
                                          z0=z0, zn=[(zn[0] + 1) % P])


def test_compress_rejects_false_statement():
    """Folding in a bogus step gives an accumulator whose honest compression
    (equal to the JAX package's) fails verification."""
    good, bogus = _toy_witness(3), _toy_witness(3)
    bogus[1] = (bogus[1] + 1) % P
    r1cs, bases = _toy(R1CS), NF.pedersen_bases(8)
    acc_i, acc_w, _ = NF.fold_chain(r1cs, [good, bogus], bases)
    assert not NF.relaxed_check(r1cs, acc_i, acc_w, bases)
    jr1cs = _toy(JR1CS)
    jacc_i, jacc_w, _ = JNF.fold_chain(jr1cs, [good, bogus], bases)
    proof = SP.compress(r1cs, acc_i, acc_w, bases)
    assert dataclasses.asdict(proof) == dataclasses.asdict(
        JSP.compress(jr1cs, jacc_i, jacc_w, bases))
    assert not SP.verify_compressed(r1cs, acc_i, proof, bases)
