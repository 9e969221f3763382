"""The port's Nova curve-cycle recursion (``models/nova_cycle``,
``models/r1cs_dsl``, ``ops/grumpkin``; host code) against the JAX
package's: the cases of ``tests/test_nova_cycle.py``, each body run once
on the port's modules and once on the JAX package's, with the port's
checks as there and every output (points, constraint systems, witnesses,
folded instances, compressed proofs) equal. Exact. The two multi-minute
chains stay gated behind ``CIRCUITS_TPU_SLOW`` as in the JAX package."""

import copy
import dataclasses
import os
import random
from types import SimpleNamespace

import pytest

from circuits_halo2_tpu.merkle import circom_mst as JCM
from circuits_halo2_tpu.models import nova_cycle as JNC
from circuits_halo2_tpu.models import r1cs_dsl as JD
from circuits_halo2_tpu.models import spartan as JSP
from circuits_halo2_tpu.ops import curve as JC1
from circuits_halo2_tpu.ops import grumpkin as JGK
from circuits_halo2_tpu_torch.merkle import circom_mst as CM
from circuits_halo2_tpu_torch.models import nova_cycle as NC
from circuits_halo2_tpu_torch.models import r1cs_dsl as D
from circuits_halo2_tpu_torch.models import spartan as SP
from circuits_halo2_tpu_torch.ops import curve as C1
from circuits_halo2_tpu_torch.ops import grumpkin as GK
from circuits_halo2_tpu_torch.ops.field import FQ_MOD, FR_MOD

PORT = SimpleNamespace(NC=NC, D=D, GK=GK, SP=SP, C1=C1, CM=CM)
JAX = SimpleNamespace(NC=JNC, D=JD, GK=JGK, SP=JSP, C1=JC1, CM=JCM)
HERE = os.path.dirname(os.path.abspath(__file__))

slow = pytest.mark.skipif(
    not os.environ.get("CIRCUITS_TPU_SLOW"),
    reason="multi-minute chain; run with CIRCUITS_TPU_SLOW=1",
)


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_grumpkin_cycle_structure():
    assert GK.P == FR_MOD and GK.ORDER == FQ_MOD
    assert GK.is_on_curve(GK.GEN)
    assert GK.mul(GK.GEN, GK.ORDER) is None
    a, b = GK.mul(GK.GEN, 123), GK.mul(GK.GEN, 456)
    assert GK.add(a, b) == GK.mul(GK.GEN, 579) == JGK.add(JGK.mul(JGK.GEN, 123),
                                                          JGK.mul(JGK.GEN, 456))
    assert (GK.GEN, GK.double(a), GK.neg(b)) == (JGK.GEN, JGK.double(a), JGK.neg(b))


def _ec_gadgets(m):
    D, GK = m.D, m.GK
    b = D.Builder(FR_MOD)
    P1, P2 = GK.mul(GK.GEN, 123), GK.mul(GK.GEN, 999)
    p1, p2 = D.PointVar.alloc(b, P1), D.PointVar.alloc(b, P2)
    assert D.ec_add(b, p1, p2).value(b) == GK.add(P1, P2)
    assert D.ec_double(b, p1).value(b) == GK.double(P1)
    pid = D.PointVar.alloc(b, None)
    assert D.ec_add(b, pid, p1).value(b) == P1
    assert D.ec_add(b, p1, pid).value(b) == P1
    assert D.ec_add(b, pid, pid).value(b) is None
    assert D.ec_add(b, p1, D.PointVar.alloc(b, GK.neg(P1))).value(b) is None
    assert D.ec_add(b, p1, p1).value(b) == GK.double(P1)
    k = 0x1ABCDEF0123456789
    bits = b.bits_of(b.new_wire(k), 125)
    assert D.ec_scalar_mul(b, bits, p1).value(b) == GK.mul(P1, k)
    sys_, wit = b.finish()
    assert sys_.check(wit) == []
    return _asdict(sys_), wit


def test_ec_gadgets_match_host():
    assert _ec_gadgets(PORT) == _ec_gadgets(JAX)


def _foreign_fold(m):
    D = m.D
    rng = random.Random(3)
    b = D.Builder(FR_MOD)
    x1v, x2v = rng.randrange(FQ_MOD), rng.randrange(FQ_MOD)
    rv = rng.getrandbits(125)
    x1 = D.alloc_foreign(b, x1v, FQ_MOD)
    x2 = D.alloc_foreign(b, x2v, FQ_MOD)
    out = D.foreign_fold(b, FQ_MOD, x1, x2, b.new_wire(rv), rv)
    assert D.foreign_value(b, out) == (x1v + rv * x2v) % FQ_MOD
    sys_, wit = b.finish()
    assert sys_.check(wit) == []
    return _asdict(sys_), wit


def test_foreign_fold_gadget():
    assert _foreign_fold(PORT) == _foreign_fold(JAX)


def _toy_secondary(m, a, b_):
    bld = m.D.Builder(m.NC.F2)
    pub = bld.new_wire(a * b_ % m.NC.F2)
    bld.public.append(1)
    wa, wb = bld.new_wire(a), bld.new_wire(b_)
    bld.assert_mul(wa, wb, pub)
    return bld.finish()


def _fold_circuit(m):
    NC, D = m.NC, m.D
    sys2, wit_full = _toy_secondary(m, 3, 5)
    bases_w = NC.pedersen_bases_e2(8)
    bases_e = NC.pedersen_bases_e2(8)
    i1, w1 = NC.make_strict(sys2, wit_full, bases_w, NC._E2)
    assert NC.strict_satisfied(sys2, i1, w1, bases_w, bases_e, NC._E2)
    _, wf2 = _toy_secondary(m, 7, 11)
    i2, w2 = NC.make_strict(sys2, wf2, bases_w, NC._E2)

    ppd = 424242
    U0 = NC.default_instance()
    W0 = NC.Witness([0] * len(w1.w), [0] * len(w1.e))
    U1, W1, _, _ = NC.nifs_fold_host(sys2, bases_e, NC._E2, ppd, U0, W0, i1, w1)
    assert NC.relaxed_satisfied(sys2, U1, W1, bases_w, bases_e, NC._E2)
    U2, W2, comT2, r2 = NC.nifs_fold_host(sys2, bases_e, NC._E2, ppd, U1, W1, i2, w2)
    assert NC.relaxed_satisfied(sys2, U2, W2, bases_w, bases_e, NC._E2)

    b = D.Builder(NC.F1)
    pp1, _ = NC._ro_params()
    ppw = b.new_wire(ppd)
    Uv = NC.InstanceVar.alloc(b, U1, NC.F2)
    uv = NC.InstanceVar.alloc(b, i2, NC.F2)
    Tv = D.PointVar.alloc(b, comT2)
    U2v, r_lc = NC.nifs_fold_circuit(b, pp1, NC.F2, ppw, Uv, uv, Tv)
    assert b.eval(r_lc) == r2
    assert U2v.com_w.value(b) == U2.com_w
    assert U2v.com_e.value(b) == U2.com_e
    assert D.foreign_value(b, U2v.u) == U2.u
    assert D.foreign_value(b, U2v.x) == U2.x[0]
    s, wit = b.finish()
    assert s.check(wit) == []
    return [_asdict(x) for x in (U1, W1, U2, W2)], comT2, r2, _asdict(s), wit


def test_fold_circuit_matches_host_nifs():
    assert _fold_circuit(PORT) == _fold_circuit(JAX)


def _toy_fq_pair(m, x_val, y_val):
    """Tiny satisfied R1CS over Fq: public out = x·y + x (num_public=1)."""
    b = m.D.Builder(FQ_MOD)
    out = b.new_wire((x_val * y_val + x_val) % FQ_MOD)
    x = b.new_wire(x_val)
    y = b.new_wire(y_val)
    b.assert_eq(b.add(b.mul(x, y), x), out)
    return b.finish(num_public=1)


def _fq_spartan(m):
    NC, SP = m.NC, m.SP
    sys_a, wit_a = _toy_fq_pair(m, 3, 5)
    sys_b, wit_b = _toy_fq_pair(m, 7, 11)
    assert len(sys_a.constraints) == len(sys_b.constraints)
    bases = NC.pedersen_bases_e2(16)
    u_a, w_a = NC.make_strict(sys_a, wit_a, bases, NC._E2)
    u_b, w_b = NC.make_strict(sys_b, wit_b, bases, NC._E2)
    assert NC.strict_satisfied(sys_a, u_a, w_a, bases, bases, NC._E2)

    U = NC.default_instance()
    W = NC.Witness([0] * (sys_a.num_wires - 2), [0] * len(sys_a.constraints))
    U, W, _, _ = NC.nifs_fold_host(sys_a, bases, NC._E2, 7, U, W, u_a, w_a)
    U, W, _, _ = NC.nifs_fold_host(sys_a, bases, NC._E2, 7, U, W, u_b, w_b)
    assert NC.relaxed_satisfied(sys_a, U, W, bases, bases, NC._E2)
    assert U.u != 1 and any(W.e)

    ctx = NC.spartan_ctx_e2()
    view = NC._spartan_view(sys_a)
    bases_pad = NC.pedersen_bases_e2(NC._pad_len(sys_a))
    proof = SP.compress(view, U, SP.RelaxedWitness(W.w, W.e), bases_pad, ctx)
    n_w = sys_a.num_wires - 1 - sys_a.num_public
    assert SP.verify_compressed(view, U, proof, bases_pad, n_w=n_w, ctx=ctx)

    bad = copy.deepcopy(proof)
    bad.w_eval = (bad.w_eval + 1) % FQ_MOD
    assert not SP.verify_compressed(view, U, bad, bases_pad, n_w=n_w, ctx=ctx)
    bad2 = copy.deepcopy(proof)
    bad2.ipa_w.a_final = (bad2.ipa_w.a_final + 1) % FQ_MOD
    assert not SP.verify_compressed(view, U, bad2, bases_pad, n_w=n_w, ctx=ctx)
    other = NC.Instance(U.com_w, U.com_e, U.u, [(U.x[0] + 1) % FQ_MOD])
    assert not SP.verify_compressed(view, other, proof, bases_pad, n_w=n_w, ctx=ctx)
    return _asdict(U), _asdict(W), _asdict(proof)


def test_fq_spartan_compress_roundtrip():
    assert _fq_spartan(PORT) == _fq_spartan(JAX)


def test_fr_spartan_ctx_matches_default():
    ctx = NC.spartan_ctx_e1()
    assert ctx.p == FR_MOD
    q = ctx.q_base()
    assert C1.g1_is_on_curve(q)
    assert q != SP._q_base()
    q2 = NC.spartan_ctx_e2().q_base()
    assert GK.is_on_curve(q2)
    assert (q, SP._q_base(), q2) == (JNC.spartan_ctx_e1().q_base(), JSP._q_base(),
                                     JNC.spartan_ctx_e2().q_base())


def _states(n):
    return [os.path.join(HERE, "fixtures_csv", "states", f"entry_16_{i}.csv")
            for i in range(1, n + 1)]


def _ivc_chain(m):
    NC = m.NC
    proofs, user_states, liab_states = m.CM.state_chain(_states(3), 0)
    z0 = [0, 0]
    ivc = NC.NovaCycleIVC(NC.NovaCycleIVC.setup(proofs[0], z0))
    pf = ivc.prove_chain(z0, proofs)
    assert pf.z_n == [user_states[-1], liab_states[-1]]
    assert ivc.verify_chain(pf)
    bad = copy.deepcopy(pf)
    bad.z_n = [pf.z_n[0] ^ 1, pf.z_n[1]]
    assert not ivc.verify_chain(bad)
    bad2 = copy.deepcopy(pf)
    bad2.u2.x[0] ^= 1
    assert not ivc.verify_chain(bad2)
    bad3 = copy.deepcopy(pf)
    bad3.U1.com_w = NC._E1.mul(bad3.U1.com_w, 2)
    assert not ivc.verify_chain(bad3)
    bad4 = copy.deepcopy(pf)
    bad4.n = pf.n + 1
    assert not ivc.verify_chain(bad4)
    return _asdict(pf)


@slow
def test_ivc_chain_end_to_end():
    assert _ivc_chain(PORT) == _ivc_chain(JAX)


def _ivc_compressed(m):
    NC = m.NC
    proofs, _, _ = m.CM.state_chain(_states(2), 0)
    z0 = [0, 0]
    params = NC.NovaCycleIVC.setup(proofs[0], z0)
    ivc = NC.NovaCycleIVC(params)
    pf = ivc.prove_chain(z0, proofs)
    assert ivc.verify_chain(pf)
    cp = NC.compress_ivc(params, pf)
    assert NC.verify_ivc_compressed(params, cp)
    assert cp.size_bytes() < 64 * 1024
    bad = copy.deepcopy(cp)
    bad.z_n = [cp.z_n[0] ^ 1, cp.z_n[1]]
    assert not NC.verify_ivc_compressed(params, bad)
    bad2 = copy.deepcopy(cp)
    bad2.pf1.w_eval = (bad2.pf1.w_eval + 1) % FR_MOD
    assert not NC.verify_ivc_compressed(params, bad2)
    bad3 = copy.deepcopy(cp)
    bad3.u2.u = 2
    assert not NC.verify_ivc_compressed(params, bad3)
    return _asdict(cp), cp.size_bytes()


@slow
def test_ivc_chain_compressed():
    assert _ivc_compressed(PORT) == _ivc_compressed(JAX)
