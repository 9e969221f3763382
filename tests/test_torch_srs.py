"""The port's SRS paths against the JAX package (tests/test_srs.py and
tests/test_curve_msm.py:103-109 mirrored): the host EC-FFT, the Lagrange
bases of ``g_to_lagrange``, ``downsize`` and its X^3 commitment,
``commit`` and ``commit_lagrange``, the upsize error,
``generate_setup_artifacts`` from a file larger than 2^k, X4's twiddle table,
and X4's plain torch version (``ec_fft_device`` on the CPU) on an infinity
lane, forward and scaled inverse. Tolerance: exact."""

import random

import pytest
import torch

from circuits_halo2_tpu.ops import curve as JC
from circuits_halo2_tpu.utils import ec_fft as JEC
from circuits_halo2_tpu.utils.srs import ParamsKZG as JaxParams
from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.ops import curve as C
from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
from circuits_halo2_tpu_torch.ops import field as F
from circuits_halo2_tpu_torch.ops import ntt as NTT
from circuits_halo2_tpu_torch.utils import ec_fft as EC
from circuits_halo2_tpu_torch.utils import pipeline
from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

torch.set_num_threads(2)


def _points(n, seed):
    rng = random.Random(seed)
    return native.g1_fixed_base_muls(C.G1_GEN, [rng.randrange(1, F.FR_MOD) for _ in range(n)])


def test_ec_fft_matches_jax_and_scalar_dft():
    rng = random.Random(1)
    k, n = 3, 8
    omega = NTT.omega_for_k(k)
    scalars = [rng.randrange(1, 2**30) for _ in range(n)]
    points = [C.g1_mul(C.G1_GEN, s) for s in scalars]
    points[5] = None
    got = EC.ec_fft(points, omega)
    assert got == JEC.ec_fft(points, omega)
    scalars[5] = 0
    assert got == [C.g1_mul(C.G1_GEN, s) for s in NTT.ntt_host(scalars, omega)]


@pytest.mark.parametrize("setup", ["port", "jax"])
def test_g_to_lagrange_matches_analytic(setup):
    p = (ParamsKZG if setup == "port" else JaxParams).setup(4)
    assert EC.g_to_lagrange(p.g, 4, "cpu") == p.g_lagrange


def test_downsize_matches_jax():
    p4 = ParamsKZG.setup(5).downsize(4, "cpu")
    want = JaxParams.setup(5).downsize(4)
    assert p4.k == 4 and len(p4.g) == 16
    assert p4.g == want.g and p4.g_lagrange == want.g_lagrange
    assert (p4.g2, p4.s_g2) == (want.g2, want.s_g2)
    omega = NTT.omega_for_k(4)
    evals = [F.fr_pow(omega, 3 * i) for i in range(16)]
    assert p4.g[3] == C.g1_msm(p4.g_lagrange, evals) == JC.g1_msm(want.g_lagrange, evals)


def test_commit_and_commit_lagrange_match_jax_srs():
    jp = JaxParams.setup(4)
    p = ParamsKZG(jp.k, jp.g, jp.g_lagrange, jp.g2, jp.s_g2)
    omega = NTT.omega_for_k(4)
    evals = [F.fr_pow(omega, 2 * i) for i in range(16)]
    assert p.commit_lagrange(evals, "cpu") == jp.g[2]
    coeffs = [random.Random(3).randrange(F.FR_MOD) for _ in range(6)]
    assert p.commit(coeffs, "cpu") == JC.g1_msm(jp.g[:6], coeffs)


def test_downsize_refuses_upsize_and_keeps_equal_k():
    p = ParamsKZG.setup(3)
    assert p.downsize(3, "cpu") is p
    with pytest.raises(ValueError):
        p.downsize(4, "cpu")


def test_setup_artifacts_from_a_larger_srs_file(tmp_path):
    """A 2^10-point file at k = 9 (LEVELS=1: the smallest circuit that fits):
    the file is downsized (host EC-FFT, as ``g_to_lagrange`` routes any size
    on the CPU) and keygen runs. The bases keep the file's first 2^9 monomial points,
    sum_i L_i(s) = 1 gives sum g_lagrange = G, and X^3 commits alike in
    both bases."""
    path = tmp_path / "srs-k10.bin"
    big = ParamsKZG.setup(10)
    big.write(str(path))
    art = pipeline.generate_setup_artifacts(9, str(path), 1, 1, 8, "cpu")
    params = art.params
    assert params.k == 9 and params.g == big.g[:512]
    assert native.g1_msm(params.g_lagrange, [1] * 512) == C.G1_GEN
    omega = NTT.omega_for_k(9)
    evals = [F.fr_pow(omega, 3 * i) for i in range(512)]
    assert native.g1_msm(params.g_lagrange, evals) == params.g[3]
    assert len(art.vk.fixed_commitments) > 0


def test_ec_fft_plain_torch_matches_host():
    """X4's plain version on the CPU at n = 4 with an infinity lane: the
    forward transform and the n^-1-scaled inverse through ``ec_fft_device``
    (the wrapper's CPU route), held to the host ``ec_fft`` of both packages."""
    n = 4
    points = _points(n, 5)
    points[1] = None
    omega = NTT.omega_for_k(2)
    omega_inv, n_inv = F.fr_inv(omega), F.fr_inv(n)
    fwd = EC.ec_fft_device(points, omega, 1, "cpu")
    assert fwd == EC.ec_fft(points, omega) == JEC.ec_fft(points, omega)
    inv = EC.ec_fft_device(points, omega_inv, n_inv, "cpu")
    want = [None if p is None else C._jac_to_affine(EC._jac_scalar_mul((*p, 1), n_inv))
            for p in JEC.ec_fft(points, omega_inv)]
    assert inv == want
    assert None not in fwd + inv


def test_twiddle_table_stages():
    n, omega = 8, NTT.omega_for_k(3)
    table = EK.twiddle_table(n, omega)
    ints = [sum(int(table[i, j]) << (16 * i) for i in range(16)) for j in range(n - 1)]
    want = []
    for s in range(3):
        step = F.fr_pow(omega, n >> (s + 1))
        want += [F.fr_pow(step, j) for j in range(1 << s)]
    assert ints == want
