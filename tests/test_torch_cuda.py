"""The CUDA kernels on the card: K1, K2, K3, K4, the K5/K6 probes, X4 (the
EC-FFT) and X0/X1 (the field arithmetic, the inversion and the NTT) against their
plain torch versions at ragged and main-path shapes,
the device tree and the Pippenger on the card against the same code on the
CPU and the native host code, X4's Lagrange bases against the analytic
ones, the incremental step chain on the card against the JAX package's
bytes, and the sharded commitment of a 1-rank NCCL world against the
single-device one. Exact (field elements; exact u32 for ``bcast``).

Every test is marked ``cuda`` and skips without a CUDA device (the kernels
have no CPU mode). The file imports no JAX, so it runs where JAX is absent:

    CIRCUITS_TPU_NO_CACHE=1 python -m pytest tests/test_torch_cuda.py -o addopts="" -m cuda -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.merkle import device_tree as TDT
from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
from circuits_halo2_tpu_torch.ops import field as F
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import msm as TM
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.ops import ntt as NTT
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
from circuits_halo2_tpu_torch.parallel import worker
from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP
from circuits_halo2_tpu_torch.utils import ec_fft as EC
from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_tasks as T  # noqa: E402

torch.set_num_threads(2)

G1_GEN = (1, 2)
FR_MOD, FQ_MOD = FT.FR.mod_int, FT.FQ.mod_int


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _fr(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("length", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 3000, 1 << 13])  # one message, a ragged block, a small level
def test_k1_matches_plain(dev, length, n):
    rng = np.random.default_rng(length * n)
    cols = [_fr(rng, n) for _ in range(length)]
    cols[0][0] = 0
    cols[-1][-1] = FR_MOD - 1
    inp = torch.stack([torch.as_tensor(FT.to_mont_limbs(c), device=dev) for c in cols])
    before = PK.hash_batch.launches
    got = PK.hash_batch(inp)
    assert PK.hash_batch.launches == before + 1
    assert got.device == inp.device and got.shape == (16, n)
    assert torch.equal(got, PK.hash_batch_ref(inp))
    assert FT.from_mont_ints(got[:, :8]) == native.poseidon_hash_batch(
        [[c[i] for c in cols] for i in range(min(n, 8))], length)


def _scan_inputs(dev, n, B, W, seed):
    """Digit-sorted K3 inputs with invalid points, repeats (doubling) and
    P + (-P) inside buckets."""
    rng = np.random.default_rng(seed)
    base = native.g1_fixed_base_muls(G1_GEN, [int(v) for v in rng.integers(1, 10**9, 6)])
    pts = [base[i] for i in rng.integers(0, 6, n)]
    pts[10] = (pts[9][0], FQ_MOD - pts[9][1])
    xs = torch.as_tensor(FT.to_mont_limbs([p[0] for p in pts], FT.FQ), device=dev)
    ys = torch.as_tensor(FT.to_mont_limbs([p[1] for p in pts], FT.FQ), device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[[5, n // 2 + 1]] = False
    digits = torch.as_tensor(np.sort(rng.integers(0, 3, (B, W, n)), axis=-1), device=dev)
    px = xs[:, None, None, :].expand(16, B, W, n).contiguous()
    py = ys[:, None, None, :].expand(16, B, W, n).contiguous()
    return px, py, valid.expand(B, W, n).contiguous(), digits


def _pippenger_inputs(dev, n, B, zeros, seed):
    """What the Pippenger hands K3 for B columns of random scalars, a share
    ``zeros`` of them 0: the bases gathered in sorted window-digit order."""
    rng = np.random.default_rng(seed)
    points = native.g1_fixed_base_muls(G1_GEN, _fr(rng, n))
    points[3] = None
    rows = [[0 if z else v for v, z in zip(_fr(rng, n), rng.random(n) < zeros)]
            for _ in range(B)]
    scal = torch.as_tensor(FT.to_mont_limbs([v for r in rows for v in r]).reshape(16, B, n),
                           device=dev)
    xs, ys, valid = TM.precompute_bases(points, dev)
    digits = TM.digits_from_mont(scal)
    perm = torch.argsort(digits, dim=-1, stable=True)
    pxy = torch.cat([xs, ys], dim=0)[:, perm]
    return pxy[:16], pxy[16:], valid[perm], torch.gather(digits, -1, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,W,zeros", [
    (256, 2, 4, None), (2048, 1, 32, None),  # crafted digits 0-2
    (1 << 13, 16, TM.NWIN, 0.0),  # k=13, a keygen batch of 16 columns
    (1 << 13, 3, TM.NWIN, 0.9),  # k=13, skewed digits: 90 % zero scalars
    (1 << 14, 3, TM.NWIN, 0.9),  # k=14 (L=256), skewed digits
])
def test_k3_matches_plain(dev, n, B, W, zeros):
    if zeros is None:
        px, py, pv, digits = _scan_inputs(dev, n, B, W, seed=n)
    else:
        px, py, pv, digits = _pippenger_inputs(dev, n, B, zeros, seed=n + B)
    assert digits.shape == (B, W, n)
    L = TM._seg_chunk_len(n)
    before = MK.segmented_scan.launches
    got = MK.segmented_scan(px, py, pv, digits, L)
    assert MK.segmented_scan.launches == before + 1
    want = MK.segmented_scan_ref(px, py, pv, digits, L)
    for g, w in zip(got, want):
        assert g.device == px.device and torch.equal(g, w)


@pytest.mark.cuda
def test_device_tree_matches_cpu(dev):
    """Depth 7 with near-u64 balances: every level equal on the card and the CPU."""
    rng = np.random.default_rng(7)
    n = 1 << 7
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    balances = rng.integers(1 << 63, 1 << 64, size=(n, 2), dtype=np.uint64)
    card = TDT.build_device_tree(digests, balances, dev)
    host = TDT.build_device_tree(digests, balances, "cpu")
    assert card.root() == host.root()
    for a, b in zip(card.level_hashes + card.level_balances,
                    host.level_hashes + host.level_balances):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_msm_commit_dev_matches_native(dev):
    rng = np.random.default_rng(11)
    n = 1 << 11
    points = native.g1_fixed_base_muls(G1_GEN, _fr(rng, n))
    points[3] = None
    points[7] = (points[6][0], FQ_MOD - points[6][1])
    rows = [_fr(rng, n) for _ in range(3)]
    rows[0][0], rows[0][1] = 0, FR_MOD - 1
    rows[0][6] = rows[0][7]
    rows[1] = [0] * n
    rows[2][: n // 2] = [FR_MOD - 1] * (n // 2)
    want = [native.g1_msm(points, r) for r in rows]
    before = MK.window_combine.launches
    assert TM.msm_auto_batch(points, rows, dev) == want
    assert MK.window_combine.launches == before + 1  # one chunk: X2 folds all three
    assert TM.msm_auto_batch(points, rows, "cpu") == want


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 16, 48])
def test_x2_matches_host_fold(dev, batch):
    """X2 on K3's partials at k=13 (chunks of 16 commitments, concatenated
    for 48) gives the host fold's points, edge scalars (0, p - 1, P + (-P),
    a None base) and an all-zero column included; one launch a call."""
    rng = np.random.default_rng(batch)
    n = 1 << 13
    points = native.g1_fixed_base_muls(G1_GEN, _fr(rng, n))
    points[3] = None
    points[7] = (points[6][0], FQ_MOD - points[6][1])
    rows = [_fr(rng, n) for _ in range(batch)]
    rows[0][0], rows[0][1] = 0, FR_MOD - 1
    rows[0][6] = rows[0][7]
    if batch > 1:
        rows[1] = [0] * n
    scal = torch.as_tensor(FT.to_mont_limbs([v for r in rows for v in r]).reshape(16, batch, n),
                           device=dev)
    xs, ys, valid = TM.precompute_bases(points, dev)
    parts = [TM._commit_dev(xs, ys, valid, scal[:, lo : lo + 16]) for lo in range(0, batch, 16)]
    acc = tuple(torch.cat([p[c] for p in parts], dim=1) for c in range(3))
    before = MK.window_combine.launches
    got = TM._affine_from_rows(MK.window_combine(*acc))
    assert MK.window_combine.launches == before + 1
    assert got == TM._combine_windows_host(tuple(c.cpu() for c in acc))
    if batch > 1:
        assert got[1] is None
    assert got[:3] == [native.g1_msm(points, r) for r in rows[:3]]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3000])
def test_k2_matches_plain_and_k1(dev, n):
    rng = np.random.default_rng(n + 1)
    s0, s1 = _fr(rng, n), _fr(rng, n)
    s0[0], s1[-1] = 0, FR_MOD - 1
    a = torch.as_tensor(FT.to_mont_limbs(s0), device=dev)
    b = torch.as_tensor(FT.to_mont_limbs(s1), device=dev)
    before = PK.permute.launches
    got = PK.permute(a, b)
    assert PK.permute.launches == before + 1
    for g, w in zip(got, PK.permute_ref(a, b)):
        assert g.device == a.device and torch.equal(g, w)
    cap = torch.as_tensor(FT.to_mont_limbs([1 << 64] * n), device=dev)
    assert torch.equal(PK.permute(a, cap)[0], PK.hash_batch(a[None]))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 3000])
def test_k4_matches_plain_and_host(dev, length, n):
    rng = np.random.default_rng(length * n + 5)
    cols = [[int.from_bytes(rng.bytes(32), "little") for _ in range(n)] for _ in range(length)]
    for c in cols:
        c[0] = 0
        c[-1] = (1 << 256) - 1
    if n > 1:
        for c in cols:
            c[1] = FR_MOD - 1
    inp = torch.stack([torch.as_tensor(FT.ints_to_limbs(c), device=dev) for c in cols])
    before = PM.hash_batch_mxu.launches
    got = PM.hash_batch_mxu(inp)
    assert PM.hash_batch_mxu.launches == before + 1
    assert got.device == inp.device and got.shape == (16, n)
    assert torch.equal(got, PM.hash_batch_mxu_ref(inp))
    msgs = [[c[i] % FR_MOD for c in cols] for i in range(min(n, 8))]
    assert FT.limbs_to_ints(got[:, :8]) == native.poseidon_hash_batch(msgs, length)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["vpu_mul", "boundary", "mxu_mul", "bcast"])
def test_k5_matches_plain(dev, variant):
    x, y = EXP.make_inputs(variant, 1000, 3, dev)
    before = EXP.run.launches
    got = EXP.run(variant, x, y, 7)
    assert EXP.run.launches == before + 1
    assert torch.equal(got, EXP.run_ref(variant, x, y, 7))


@pytest.mark.cuda
def test_k6_check(dev):
    before = EXP.mxu_mul_once.launches
    assert EXP.check_mxu_mul_exact(dev) == 0
    assert EXP.mxu_mul_once.launches == before + 1


@pytest.mark.cuda
def test_tree_root_mxu_matches_device_tree(dev):
    rng = np.random.default_rng(9)
    n = 1 << 7
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    balances = rng.integers(1 << 63, 1 << 64, size=(n, 2), dtype=np.uint64)
    assert TDT.tree_root_mxu(digests, balances, dev) == TDT.build_device_tree(
        digests, balances, dev).root()


@pytest.mark.cuda
def test_x4_matches_plain(dev):
    """n = 2 with an infinity lane, forward and scaled inverse as a batch of
    two: one stage launch and one scale launch, equal to the plain version."""
    points = [None, native.g1_fixed_base_muls(G1_GEN, [12345])[0]]
    args = EC.transform_inputs(points, [(FR_MOD - 1, 1), (FR_MOD - 1, F.fr_inv(2))], dev)
    before = EK.ec_fft.launches
    got = EK.ec_fft(*args)
    assert EK.ec_fft.launches == before + 2
    for g, w in zip(got, EK.ec_fft_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 16])
def test_x4_two_thread_combine_matches_plain(dev, n):
    """Each butterfly's two threads (GLV halves of its twiddle, summed through
    shared memory) and the scale pass's pairs, with an infinity lane, a batch
    of three transforms whose scales have both halves nonzero, a negative
    half, or a zero second half: equal to the plain version, one launch a
    stage and one for the scale."""
    rng = np.random.default_rng(n)
    points = native.g1_fixed_base_muls(G1_GEN, _fr(rng, n))
    points[n // 2] = None
    omega = F.fr_pow(F.FR_ROOT_OF_UNITY, 1 << (F.FR_TWO_ADICITY + 1 - n.bit_length()))
    scales = [EK.LAMBDA + 12345, F.fr_inv(n), FR_MOD - 1]
    assert [EK.glv_split(k) for k in scales[::2]] == [(12345, 1), (-1, 0)]
    assert EK.glv_split(scales[1])[0] < 0 < EK.glv_split(scales[1])[1]
    transforms = [(omega, scales[0]), (F.fr_inv(omega), scales[1]), (omega, scales[2])]
    args = EC.transform_inputs(points, transforms, dev)
    before = EK.ec_fft.launches
    got = EK.ec_fft(*args)
    assert EK.ec_fft.launches == before + n.bit_length()
    for g, w in zip(got, EK.ec_fft_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 11, 13])
def test_x4_lagrange_bases_match_analytic(dev, k):
    """``g_to_lagrange`` through X4 (2^k >= DEVICE_MIN) gives the setup's
    analytic Lagrange bases."""
    params = ParamsKZG.setup(k)
    assert EC.g_to_lagrange(params.g, k, dev) == params.g_lagrange


@pytest.mark.cuda
def test_incremental_chain_on_the_card_equals_jax_bytes(dev):
    """``prove_chain`` over entry_16 rounds 1-3 on the card (trees through
    K1, proofs through K3) gives the JAX package's step proofs
    (tests/fixtures_torch_incremental.json, part ``steps``)."""
    import json
    from pathlib import Path

    from circuits_halo2_tpu_torch.models import incremental as INC
    from circuits_halo2_tpu_torch.utils import pipeline

    here = Path(__file__).parent
    fix = json.loads((here / "fixtures_torch_incremental.json").read_text())["steps"]
    art = pipeline.generate_incremental_artifacts(
        fix["k"], str(here / fix["ptau"]), fix["levels"], fix["n_currencies"], fix["n_bytes"],
        device=dev)
    k1, k3 = PK.hash_batch.launches, MK.segmented_scan.launches
    chain = INC.prove_chain(art, [str(here / p) for p in fix["csvs"]], fix["user_index"])
    assert PK.hash_batch.launches > k1 and MK.segmented_scan.launches > k3
    assert [s.proof.hex() for s in chain.steps] == fix["proofs"]
    assert [hex(v) for v in chain.liab_states] == fix["liab_states"]
    assert INC.verify_chain(art, chain)


@pytest.mark.cuda
def test_nccl_rank_commit_equals_single_device(dev):
    """A 1-rank NCCL world on the card (``parallel/worker.launch``): the
    sharded commitment, its gather through NCCL, equals the single-device
    commitment and the host Pippenger."""
    got = worker.launch(1, "nccl", "cuda", f"{T.__file__}:nccl_commit", timeout=300)[0]
    assert got["backend"] == "nccl" and got["equal"]
    assert got["collectives"]["all_gather"] == 1
    points, scal = T.commit_inputs()
    assert tuple(int(v, 16) for v in got["point"]) == native.g1_msm(points, scal)


def _limbs(dev, shape, rng, spec=FT.FR):
    """Canonical Montgomery limbs of random elements, shaped (16, *shape)."""
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.mod_int for _ in range(count)]
    vals[0] = 0
    vals[-1] = spec.mod_int - 1
    return torch.as_tensor(FT.to_mont_limbs(vals, spec), device=dev).reshape((16,) + tuple(shape))


def _operand_pairs(dev, rng, spec):
    """(a, b) pairs as the path hands them over: a lane table and a
    challenge broadcast over (16, U, B, n) columns, a strided column view,
    a transposed view against an expanded constant, and raw limbs (to_mont's
    operand, any value below 2^256) against a constant."""
    cols = _limbs(dev, (2, 3, 1000), rng, spec)
    wide = _limbs(dev, (2, 5, 1000), rng, spec)
    raw = torch.as_tensor(rng.integers(0, 1 << 16, (16, 4, 777)), device=dev)
    return {
        "lane_table": (cols, _limbs(dev, (1, 1, 1000), rng, spec)),
        "challenge": (cols, _limbs(dev, (2, 1, 1), rng, spec)),
        "column_view": (wide[:, :, 3], wide[:, :, 1]),
        "transposed": (wide.transpose(2, 3),
                       _limbs(dev, (1, 1, 1), rng, spec).expand(16, 2, 1000, 5)),
        "raw": (raw, FT.const_tensor(spec.r2, dev, 3)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_x0a_x0b_match_plain(dev, field):
    """X0a (mont_mul) and X0b (add, sub, neg) on broadcast, strided and raw
    operands equal their plain versions limb for limb, one launch each."""
    spec = FT.FR if field == "fr" else FT.FQ
    rng = np.random.default_rng(len(field))
    for name, (a, b) in _operand_pairs(dev, rng, spec).items():
        before = FT.mont_mul.launches, FT.linear.launches
        got = FT.mont_mul(a, b, spec)
        assert FT.mont_mul.launches == before[0] + 1
        assert got.is_contiguous() and torch.equal(got, FT.mont_mul_ref(a, b, spec)), name
        if name == "raw":
            continue
        for fn, ref in ((FT.add_mod, FT.add_mod_ref), (FT.sub_mod, FT.sub_mod_ref)):
            assert torch.equal(fn(a, b, spec), ref(a, b, spec)), (name, fn.__name__)
        assert torch.equal(FT.neg_mod(a, spec), FT.neg_mod_ref(a, spec)), name
        assert FT.linear.launches == before[1] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("shape", [(1, 3, 1), (1 << 16,)])
def test_x0c_matches_plain(dev, shape, field):
    """X0c: the divstep inversion on batch_inv_dev's (16, 1, 3, 1) and on 2^16
    elements (0 -> 0) in one launch, equal to the plain Fermat chain; a^-1 a
    = 1; and on raw limbs (any value below 2^256) equal to the chain."""
    spec = FT.FR if field == "fr" else FT.FQ
    rng = np.random.default_rng(len(shape) + len(field))
    a = _limbs(dev, shape, rng, spec)
    before = FT.inv_mont.launches
    got = FT.inv_mont(a, spec)
    assert FT.inv_mont.launches == before + 1
    assert torch.equal(got, FT.mont_pow_ref(a, spec.mod_int - 2, spec))
    one = FT.const_tensor(spec.one_mont, dev, a.dim()).expand_as(a)
    nonzero = ~FT.is_zero(a)
    assert torch.equal(FT.mont_mul(got, a, spec)[:, nonzero], one[:, nonzero])
    assert torch.equal(got[:, ~nonzero], a[:, ~nonzero])
    raw = torch.as_tensor(rng.integers(0, 1 << 16, (16, 999)), device=dev)
    raw[:, 0] = 0xFFFF
    assert torch.equal(FT.inv_mont(raw, spec), FT.mont_pow_ref(raw, spec.mod_int - 2, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", [0, 5, FR_MOD - 2, (1 << 256) - 1])
def test_mont_pow_chain_matches_plain(dev, exponent):
    """The power chain (mont_pow, off the prover's path) in one launch equals
    the plain loop."""
    a = _limbs(dev, (2, 100), np.random.default_rng(exponent % 1000))
    before = FT.mont_pow.launches
    got = FT.mont_pow(a, exponent)
    assert FT.mont_pow.launches == before + 1
    assert torch.equal(got, FT.mont_pow_ref(a, exponent))


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows", [(1, 3), (6, 5), (11, 1), (13, 3), (16, 2), (19, 1), (22, 1)])
def test_x1_matches_plain(dev, k, rows):
    """X1 through ntt and intt (one launch a transform up to 2^11, two above,
    up to 2^22) equals ntt_ref, and intt undoes ntt."""
    rng = np.random.default_rng(k)
    a = _limbs(dev, (rows, 1 << k), rng)
    omega = NTT.omega_for_k(k)
    before = NTT.ntt_passes.launches
    got = NTT.ntt(a, omega)
    assert NTT.ntt_passes.launches == before + (1 if k <= NTT.ONE_PASS_MAX_LOG else 2)
    assert torch.equal(got, NTT.ntt_ref(a, omega))
    assert torch.equal(NTT.intt(got, omega), a)


@pytest.mark.cuda
def test_x1_one_pass_plans_match_plain(dev):
    """At 2^11 the one pass spreads a row over a cluster of 8 blocks when the
    rows are few (the k=11 prove's 9 and 20 columns) and over none when they
    fill the card, and at 2^10 alike; each equals ntt_ref. A transposed view
    (as parallel/ntt_sharded hands one over) is read right."""
    rng = np.random.default_rng(7)
    for k, rows, cluster in ((11, 9, 8), (11, 20, 8), (11, 264, 1), (10, 4, 8)):
        (launch,) = NTT.plan(1 << k, rows)
        assert (launch["kind"], launch["cluster"]) == ("one pass", cluster)
        a, omega = _limbs(dev, (rows, 1 << k), rng), NTT.omega_for_k(k)
        assert torch.equal(NTT.ntt_passes(a, omega, 1 << k), NTT.ntt_ref(a, omega))
    wide = _limbs(dev, (2, 1 << 7, 1 << 6), rng)
    view = wide.transpose(2, 3)
    assert torch.equal(NTT._ntt_device(view, NTT.omega_for_k(7)),
                       NTT.ntt_ref(view, NTT.omega_for_k(7)))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["coeff_to_extended", "lagrange_to_coeff",
                                    "extended_to_coeff", "vanishing_to_coeff"])
def test_x1_fused_domain_transforms(dev, method):
    """Each Domain transform at k=13 launches X1 only (no X0a) and equals its
    plain sequence inside FT.plain()."""
    from circuits_halo2_tpu_torch.utils import poly_device as PD

    dom = PD.domain(13, 5, str(dev))
    rng = np.random.default_rng(len(method))
    a = _limbs(dev, (3, dom.n if method in ("coeff_to_extended", "lagrange_to_coeff")
                     else dom.n_ext), rng)
    fn = getattr(dom, method)
    before = FT.mont_mul.launches, NTT.ntt_passes.launches
    got = fn(a)
    assert (FT.mont_mul.launches, NTT.ntt_passes.launches) == (before[0], before[1] + 2)
    with FT.plain():
        want = fn(a) if method != "vanishing_to_coeff" else dom.extended_to_coeff(
            dom.divide_by_vanishing(a))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_plain_versions_launch_no_x0(dev):
    """Inside plain() (and so in every other kernel's plain version) the field
    operations run plain torch on the card: no X0 or X1 launch."""
    rng = np.random.default_rng(3)
    a = _limbs(dev, (64,), rng)
    counters = (FT.mont_mul, FT.linear, FT.inv_mont, FT.mont_pow, NTT.ntt_passes)
    before = [c.launches for c in counters]
    PK.hash_batch_ref(a[None].expand(2, 16, 64))
    NTT.ntt_ref(a, NTT.omega_for_k(6))
    NTT.transform_ref(a, NTT.omega_for_k(7), 128, out_scale=NTT.const_lanes(5, str(dev)))
    with FT.plain():
        FT.inv_mont(FT.add_mod(a, a))
        FT.mont_pow(a, 5)
    after = [c.launches for c in counters]
    assert after == before
