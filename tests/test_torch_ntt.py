"""The port's NTT and polynomial domain against the JAX package at 2^11 (and
its host references). Tolerance: exact (field elements)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circuits_halo2_tpu.ops import field as F
from circuits_halo2_tpu.ops import ntt as JN
from circuits_halo2_tpu.utils import poly_device as JPD
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import ntt as TN
from circuits_halo2_tpu_torch.utils import poly_device as TPD

torch.set_num_threads(2)

P = F.FR_MOD
K = 11
N = 1 << K


def _vals(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    out[0], out[-1] = 0, P - 1
    return out


def _dev(vals, shape=None) -> torch.Tensor:
    t = torch.as_tensor(FT.to_mont_limbs(vals))
    return t if shape is None else t.reshape(shape)


def test_host_helpers_match_jax():
    assert TN.omega_for_k(K) == JN.omega_for_k(K)
    assert np.array_equal(TN.bit_reverse_indices(64), JN.bit_reverse_indices(64))
    v = _vals(64, 1)
    w = JN.omega_for_k(6)
    assert TN.ntt_host(v, w) == JN.ntt_host(v, w)
    assert TN.intt_host(v, w) == JN.intt_host(v, w)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax_at_2_11(inverse):
    cols = [_vals(N, 2), _vals(N, 3)]
    flat = [v for c in cols for v in c]
    a = _dev(flat, (16, 2, N))
    omega = TN.omega_for_k(K)
    tfn, jfn = (TN.intt, JN.intt) if inverse else (TN.ntt, JN.ntt)
    got = tfn(a, omega)
    want = np.asarray(jfn(jnp.asarray(a.numpy().astype(np.uint32)), omega))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    host = (JN.intt_host if inverse else JN.ntt_host)(cols[1], omega)
    assert FT.from_mont_ints(got[:, 1]) == host


def test_domain_tables_match_jax():
    tdom = TPD.domain(K, 6, "cpu")
    jdom = JPD.domain(K, 6)
    assert (tdom.n_ext, tdom.omega, tdom.omega_ext, tdom.rot_scale) == (
        jdom.n_ext, jdom.omega, jdom.omega_ext, jdom.rot_scale)
    for name in ("_coset", "_coset_inv", "_zh_inv"):
        assert np.array_equal(getattr(tdom, name).numpy(),
                              np.asarray(getattr(jdom, name)).astype(np.int64)), name
    w = tdom.omega
    assert FT.from_mont_ints(tdom.omega_pows) == [pow(w, i, P) for i in range(N)]
    we = tdom.omega_ext
    assert FT.from_mont_ints(tdom.x_ext[:, :64]) == [7 * pow(we, i, P) % P for i in range(64)]


def test_extended_round_trip_and_rotations():
    dom = TPD.domain(K, 6, "cpu")
    coeffs = _dev(_vals(N, 4), (16, 1, N))
    ext = dom.coeff_to_extended(coeffs)
    assert ext.shape == (16, 1, dom.n_ext)
    back = dom.extended_to_coeff(ext)
    assert torch.equal(back[..., :N], coeffs) and not back[..., N:].any()
    x = FT.from_mont_ints(ext[:, 0, :8])
    c = FT.from_mont_ints(coeffs[:, 0])
    pts = [7 * pow(dom.omega_ext, i, P) % P for i in range(8)]
    assert x == [sum(ci * pow(pt, j, P) for j, ci in enumerate(c)) % P for pt in pts]
    assert torch.equal(dom.rotate_base(coeffs, 1)[..., 0], coeffs[..., 1])
    assert torch.equal(dom.rotate_ext(ext, -1)[..., dom.rot_scale], ext[..., 0])


def test_poly_primitives_match_host():
    vals = _vals(64, 5)
    vals[0] = 3  # batch inversion needs nonzero inputs
    a = _dev(vals)
    prefix, acc = [], 1
    for v in vals:
        acc = acc * v % P
        prefix.append(acc)
    assert FT.from_mont_ints(TPD.mont_cumprod(a)) == prefix
    nz = [v or 1 for v in vals]
    assert FT.from_mont_ints(TPD.batch_inv_dev(_dev(nz))) == [pow(v, -1, P) for v in nz]
    z = 123456789
    pw = TPD.powers_dev(z, 64, "cpu")
    assert FT.from_mont_ints(pw) == [pow(z, i, P) for i in range(64)]
    assert FT.from_mont_ints(TPD.eval_coeffs_at(a, pw)) == [
        sum(v * pow(z, i, P) for i, v in enumerate(vals)) % P]
    # (X - z)·q(X) + f(z) == f(X)
    q = FT.from_mont_ints(TPD.divide_linear_dev(a, z))
    fz = sum(v * pow(z, i, P) for i, v in enumerate(vals)) % P
    rebuilt = [(-z * q[0] + fz) % P] + [(q[i - 1] - z * q[i]) % P for i in range(1, 64)]
    assert rebuilt == vals and q[-1] == 0
    assert TPD.intt_cols([vals], TN.omega_for_k(6), "cpu") == [
        JN.intt_host(vals, TN.omega_for_k(6))]
