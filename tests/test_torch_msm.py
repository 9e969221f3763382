"""K3's plain scan and the port's Pippenger against the JAX package:
limb-exact against ``msm._segmented_sum_parts`` (the case of
tests/test_curve_msm.py:185-207 plus doubling and P + (-P) lanes), and
``msm_commit_dev`` against the native host ``g1_msm`` at 2^11 with the edge
cases of tests/test_curve_msm.py:78-82. Tolerance: exact."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circuits_halo2_tpu.ops import curve as C
from circuits_halo2_tpu.ops import field as F
from circuits_halo2_tpu.ops import field_jax as FJ
from circuits_halo2_tpu.ops import msm as JM
from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import msm as TM
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.utils import tracing as TR

torch.set_num_threads(2)


def _scan_case(n=64, B=2, W=2, seed=2):
    """Sorted-segment inputs in the JAX layout (uint32 limbs)."""
    rng = random.Random(seed)
    base = [C.g1_mul(C.G1_GEN, rng.randrange(1, 10**9)) for _ in range(6)]
    pts = [base[rng.randrange(6)] for _ in range(n)]
    pts[10] = C.g1_neg(pts[9])
    xs = FJ.ints_to_limbs([(p[0] << 256) % C.Q for p in pts])
    ys = FJ.ints_to_limbs([(p[1] << 256) % C.Q for p in pts])
    valid = np.ones(n, bool)
    valid[[5, n // 2 + 1]] = False
    digits = np.stack([np.sort(rng.choices(range(3), k=n)) for _ in range(B * W)])
    digits = digits.reshape(B, W, n).astype(np.int32)
    px = np.broadcast_to(xs[:, None, None, :], (16, B, W, n))
    py = np.broadcast_to(ys[:, None, None, :], (16, B, W, n))
    pv = np.broadcast_to(valid, (B, W, n))
    return px, py, pv, digits


def _torch(px, py, pv, digits):
    return (torch.as_tensor(px.astype(np.int64)), torch.as_tensor(py.astype(np.int64)),
            torch.as_tensor(pv.copy()), torch.as_tensor(digits.astype(np.int64)))


def _assert_parts_equal(ref, got):
    for k in range(3):
        assert np.array_equal(np.asarray(ref[0][k]).astype(np.int64), got[0][k].numpy())
        assert np.array_equal(np.asarray(ref[1][k]).astype(np.int64), got[1][k].numpy())
    assert np.array_equal(np.asarray(ref[2]), got[2].numpy())
    assert ref[3] == got[3]


@pytest.mark.parametrize("seed", [2, 3])
def test_scan_parts_match_jax(seed):
    px, py, pv, digits = _scan_case(seed=seed)
    ref = JM._segmented_sum_parts(jnp.asarray(px), jnp.asarray(py), jnp.asarray(pv),
                                  jnp.asarray(digits))
    _assert_parts_equal(ref, TM._segmented_sum_parts(*_torch(px, py, pv, digits)))


def test_curve_formulas_match_jax():
    px, py, pv, digits = _scan_case(n=16, B=1, W=1, seed=4)
    tx, ty = _torch(px, py, pv, digits)[:2]
    x, y = tx.reshape(16, -1), ty.reshape(16, -1)
    one = torch.as_tensor(FT.FQ.one_mont).reshape(16, 1).expand_as(x)
    p = (x, y, one)
    q = (x.roll(1, -1), y.roll(1, -1), one)
    jp = tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in p)
    jq = tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in q)
    for got, want in ((TM.jac_double(p), JM.jac_double(jp)), (TM.jac_add(p, q), JM.jac_add(jp, jq))):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.fixture(scope="module")
def edge_msm():
    rng = random.Random(11)
    n = 1 << 11
    points = native.g1_fixed_base_muls(C.G1_GEN, [rng.randrange(1, F.FR_MOD) for _ in range(n)])
    points[3] = None
    points[7] = C.g1_neg(points[6])
    rows = [[rng.randrange(F.FR_MOD) for _ in range(n)] for _ in range(3)]
    rows[0][0], rows[0][1] = 0, F.FR_MOD - 1
    rows[0][6] = rows[0][7]
    rows[1] = [0] * n
    rows[2][: n // 2] = [F.FR_MOD - 1] * (n // 2)
    return points, rows


def test_msm_commit_dev_matches_native(edge_msm):
    """The bucket stage and the window combine, at 2^11 with the edge rows,
    equal the JAX package's ``msm_auto_batch`` and the port's native MSM."""
    points, rows = edge_msm
    got = TM.msm_auto_batch(points, rows, "cpu")
    assert got == JM.msm_auto_batch(points, rows)
    assert got == [native.g1_msm(points, r) for r in rows]


def test_msm_small_cases_match_reference():
    """The edge cases of tests/test_curve_msm.py:78-82, padded to 256 lanes."""
    g = C.G1_GEN
    cases = [([g], [1], g), ([g], [0], None), ([g, None], [3, 5], C.g1_mul(g, 3)),
             ([g, g], [1, F.FR_MOD - 1], None), ([g, C.g1_neg(g)], [7, 7], None)]
    for pts, scal, want in cases:
        assert TM.msm_auto(pts, scal, "cpu") == want


def test_cpu_combine_takes_the_host_route():
    """CPU partials take the host fold, counted on the ``host`` route with
    its ``msm_combine`` span, and give the JAX package's points; X2 does
    not launch."""
    g = C.G1_GEN
    before = MK.window_combine.launches
    TR.drain()
    TR.enable()
    try:
        got = TM.msm_auto_batch([g, C.g1_neg(g)], [[3, 1], [5, 5]], "cpu")
    finally:
        TR.disable()
    spans, counts = TR.drain()
    assert got == [C.g1_mul(g, 2), None] == JM.msm_auto_batch([g, C.g1_neg(g)], [[3, 1], [5, 5]])
    assert counts == {("msm_combine", "host"): {"commitments": 2}}
    assert [s.name for s in spans].count("msm_combine") == 1
    assert MK.window_combine.launches == before


def _partials(shape=(16, 2, 32, 32), dtype=torch.int64):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case", ["cpu", "windows", "dtype", "mismatch"])
def test_window_combine_refuses_what_it_does_not_take(case):
    """X2's wrapper raises before any launch on what the kernel does not
    take: a CPU tensor (the host fold's), another partial grid, another
    dtype, coordinates of different shapes."""
    x = y = z = _partials()
    if case == "windows":
        x = y = z = _partials((16, 2, 32, 16))
    elif case == "dtype":
        x = _partials(dtype=torch.int32)
    elif case == "mismatch":
        z = _partials((16, 3, 32, 32))
    with pytest.raises(ValueError, match="window_combine"):
        MK.window_combine(x, y, z)


def test_digits_match_jax():
    rng = random.Random(5)
    vals = [0, 1, F.FR_MOD - 1] + [rng.randrange(F.FR_MOD) for _ in range(29)]
    limbs = FT.to_mont_limbs(vals).reshape(16, 2, 16)
    want = np.asarray(JM.digits_from_mont(jnp.asarray(limbs.astype(np.uint32))))
    assert np.array_equal(TM.digits_from_mont(torch.as_tensor(limbs)).numpy(), want)


@pytest.mark.slow
def test_scan_parts_match_pallas_interpret():
    """Against the TPU kernel itself, run in Pallas interpret mode on CPU."""
    px, py, pv, digits = _scan_case()
    ref = JM._segmented_sum_parts_pallas(jnp.asarray(px), jnp.asarray(py), jnp.asarray(pv),
                                         jnp.asarray(digits), interpret=True)
    _assert_parts_equal(ref, TM._segmented_sum_parts(*_torch(px, py, pv, digits)))
