"""K4 (the tensor-core sponge of plain residues) and K5/K6 (its probes) in
their plain torch versions, against the JAX package: the host ``hash_n``,
the eager bodies of ``ops/poseidon_mxu.py`` (``_mxu_mul`` / ``_mxu_reduce``)
and of ``scripts/exp_poseidon_mxu.py`` (the probe kernels' bodies, called
outside ``pallas_call``), and one Python-int model of each probe's
recurrence. Tolerance: exact field elements, or exact u32 for ``bcast``.
The JAX outputs are non-canonical residues and are compared after ``% p``.
Whole Pallas kernels in interpret mode are the ``slow`` cases."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuits_halo2_tpu.ops import poseidon as JP
from circuits_halo2_tpu.ops import poseidon_fast as PF
from circuits_halo2_tpu.ops import poseidon_mxu as JM
from circuits_halo2_tpu.ops import poseidon_pallas2 as P2
from circuits_halo2_tpu_torch.merkle import device_tree as TDT
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP

torch.set_num_threads(2)

P = PM.P
NL = 18
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jexp():
    """The JAX package's experiment script, imported by path."""
    spec = importlib.util.spec_from_file_location("jax_exp_poseidon_mxu",
                                                  ROOT / "scripts" / "exp_poseidon_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _w():
    return jnp.asarray(JM._RW).astype(jnp.bfloat16)


def _vals(rng, n, edges=True):
    out = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    if edges:
        out[0], out[-1] = 0, P - 1
    return out


def _l15(vals) -> np.ndarray:
    """(18, 1, n) uint32 15-bit limbs: a (sublane, lane) tile of the JAX kernels."""
    return PF.ints_to_limbs15(vals)[:, None, :]


def _ints15(arr) -> list[int]:
    return PF.limbs15_to_ints(np.asarray(arr).reshape(NL, -1))


def _t(vals) -> torch.Tensor:
    return torch.as_tensor(FT.ints_to_limbs(vals))


def _model(xs, ys, iters, rinv):
    """The probes' recurrence x, y <- x·y·R^-1, x; then x + y, mod p."""
    out = []
    for x, y in zip(xs, ys):
        for _ in range(iters):
            x, y = x * y * rinv % P, x
        out.append((x + y) % P)
    return out


def test_reduce_weights():
    w = PM.reduce_weights()
    assert w.shape == (32, 64) and w.dtype == np.uint8
    for h in (0, 31, 32, 47, 63):
        assert int.from_bytes(bytes(w[:, h]), "little") == pow(2, 8 * h, P)
    # B fragments of mma.m16n8k32: lane 4g + t, word (ks·4 + nt)·2 + reg,
    # byte e is W[8·nt + g][32·ks + 16·reg + 4t + e]
    wb = PM.fragment_weights()
    assert wb.shape == (32, 16) and wb.dtype == np.uint32
    frags = wb.view(np.uint8).reshape(8, 4, 2, 4, 2, 4)  # g t ks nt reg e
    assert np.array_equal(frags[5, 2, 1, 3, 0], w[29, 40:44])
    assert np.array_equal(frags[:, :, 0, 0, 0].reshape(8, 16), w[0:8, 0:16])
    assert np.array_equal(frags[:, :, 1, 2, 1].reshape(8, 16), w[16:24, 48:64])


@pytest.mark.parametrize("length", [1, 2, 3, 4])
def test_hash_batch_mxu_ref_matches_jax_host(length):
    """Plain residues in, including 0, p - 1 and 2^256 - 1 (every limb at its
    maximum, above p) in every word."""
    rng = np.random.default_rng(40 + length)
    msgs = [[int.from_bytes(rng.bytes(32), "little") for _ in range(length)] for _ in range(4)]
    msgs[0], msgs[1], msgs[2] = [0] * length, [P - 1] * length, [(1 << 256) - 1] * length
    inp = torch.stack([_t([m[i] for m in msgs]) for i in range(length)])
    got = PM.hash_batch_mxu(inp)
    assert torch.equal(got, PM.hash_batch_mxu_ref(inp))
    assert FT.limbs_to_ints(got) == [JP.hash_n([v % P for v in m]) for m in msgs]


def test_hash_many_mxu_on_cpu():
    msgs = [[3, 4], [P - 1, 0], [5, 1 << 255]]
    assert PM.hash_many_mxu(msgs, "cpu") == [JP.hash_n([v % P for v in m]) for m in msgs]


def test_mul_matches_jax_mxu_mul():
    rng = np.random.default_rng(2)
    xs, ys = _vals(rng, 5), _vals(rng, 5)
    ys[0] = P - 1
    got = FT.limbs_to_ints(PM.mul_ref(_t(xs), _t(ys)))
    a, b = _l15(xs), _l15(ys)
    jout = JM._mxu_mul(_w(), [jnp.asarray(a[i]) for i in range(NL)],
                       [jnp.asarray(b[i]) for i in range(NL)])
    want = [x * y % P for x, y in zip(xs, ys)]
    assert got == want
    assert [v % P for v in _ints15(np.stack([np.asarray(v) for v in jout]))] == want


def test_reduce_matches_jax_mxu_reduce_on_canonical_values():
    """One reduction of a value already below p: both give it back mod p."""
    rng = np.random.default_rng(3)
    vals = _vals(rng, 4)
    t = torch.cat([_t(vals), torch.zeros((16, 4), dtype=FT.DTYPE)])
    assert FT.limbs_to_ints(PM.reduce_ref(t)) == vals
    cols = _l15(vals)
    zero = jnp.zeros_like(jnp.asarray(cols[0]))
    jout = JM._mxu_reduce(_w(), [jnp.asarray(cols[i]) for i in range(NL)] + [zero] * NL)
    assert [v % P for v in _ints15(np.stack([np.asarray(v) for v in jout]))] == vals


def test_reduce_at_its_bounds():
    """Products of p - 1 and of 2^256 - 1 (the widest inputs), and zero."""
    vals = [0, P - 1, (1 << 256) - 1, 1 << 255]
    a = _t(vals)
    assert FT.limbs_to_ints(PM.mul_ref(a, a)) == [v * v % P for v in vals]
    assert FT.limbs_to_ints(PM.canon256_ref(a)) == [v % P for v in vals]


@pytest.mark.parametrize("iters", [1, 40])
def test_bcast_matches_jax_body(jexp, iters):
    """K5 ``bcast``: the same uint32 arrays, exact."""
    rng = np.random.default_rng(iters)
    x = rng.integers(0, 1 << 32, size=(NL, 1, 6), dtype=np.uint32)
    jexp.ITERS = iters
    out = np.zeros_like(x)
    jexp._kern_bcast(None, jnp.asarray(x), None, out)
    xt = torch.as_tensor(x.reshape(NL, 6).astype(np.int64))
    got = EXP.run("bcast", xt, xt, iters)
    assert np.array_equal(got.numpy(), out.reshape(NL, 6).astype(np.int64))


def test_mxu_mul_probe_matches_jax_body_and_model(jexp):
    """K5 ``mxu_mul``: plain residues, so both equal the R = 1 model."""
    rng = np.random.default_rng(5)
    xs, ys, iters = _vals(rng, 4), _vals(rng, 4), 3
    want = _model(xs, ys, iters, 1)
    assert FT.limbs_to_ints(EXP.run("mxu_mul", _t(xs), _t(ys), iters)) == want
    jexp.ITERS = iters
    out = np.zeros((NL, 1, 4), dtype=np.uint32)
    jexp._make_kern_mxu_mul("free")(_w(), jnp.asarray(_l15(xs)), jnp.asarray(_l15(ys)), out)
    assert [v % P for v in _ints15(out)] == want


def test_vpu_mul_probe_against_the_model_per_radix(jexp):
    """K5 ``vpu_mul``: Montgomery products, R = 2^255 in the JAX package and
    R = 2^256 in the port, each against the model with its own R."""
    rng = np.random.default_rng(6)
    xs, ys, iters = _vals(rng, 4), _vals(rng, 4), 3
    got = FT.limbs_to_ints(EXP.run("vpu_mul", _t(xs), _t(ys), iters))
    assert got == _model(xs, ys, iters, pow(1 << 256, -1, P))
    jexp.ITERS = iters
    out = np.zeros((NL, 1, 4), dtype=np.uint32)
    jexp._kern_vpu_mul(None, jnp.asarray(_l15(xs)), jnp.asarray(_l15(ys)), out)
    assert [v % P for v in _ints15(out)] == _model(xs, ys, iters, pow(1 << 255, -1, P))


def test_boundary_probe_against_the_model():
    """K5 ``boundary``: t = v + v·2^256 reduced, ``iters`` times."""
    rng = np.random.default_rng(7)
    vals, iters = _vals(rng, 4), 5
    want = []
    for v in vals:
        for _ in range(iters):
            v = v * (1 + (1 << 256)) % P
        want.append(v)
    x = _t(vals)
    assert FT.limbs_to_ints(EXP.run("boundary", x, x, iters)) == want


def test_check_k6_on_cpu_and_against_jax_reduce():
    """K6: one reduced multiply of the JAX probe's 4 random 248-bit values."""
    assert EXP.check_mxu_mul_exact("cpu") == 0
    rng = np.random.default_rng(1)
    xs = [int.from_bytes(rng.bytes(31), "little") for _ in range(4)]
    ys = [int.from_bytes(rng.bytes(31), "little") for _ in range(4)]
    got = FT.limbs_to_ints(EXP.mxu_mul_once(_t(xs), _t(ys)))
    a, b = _l15(xs), _l15(ys)
    cols = P2._mul_dyn([jnp.asarray(a[i]) for i in range(NL)], [jnp.asarray(b[i]) for i in range(NL)])
    jout = JM._mxu_reduce(_w(), cols)
    want = [x * y % P for x, y in zip(xs, ys)]
    assert got == want
    assert [v % P for v in _ints15(np.stack([np.asarray(v) for v in jout]))] == want


def test_probe_wrappers_check_their_arguments():
    x = _t([1, 2])
    with pytest.raises(ValueError):
        EXP.run("nope", x, x, 1)
    with pytest.raises(ValueError):
        EXP.run("bcast", x, x, 1)  # bcast wants 18 rows
    with pytest.raises(ValueError):
        PM.hash_batch_mxu(x)  # not (L, 16, N)


def test_tree_root_mxu_matches_k1_tree():
    """The tree's root through K4 (raw digests and sums) equals K1's tree."""
    rng = np.random.default_rng(8)
    n = 1 << 2
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    balances = rng.integers(1 << 63, 1 << 64, size=(n, 2), dtype=np.uint64)
    want = TDT.build_device_tree(digests, balances, "cpu").root()
    assert TDT.tree_root_mxu(digests, balances, "cpu") == want


@pytest.mark.slow
def test_matches_hash_many_mxu_interpret():
    """Against the TPU kernel itself, in Pallas interpret mode on the CPU."""
    msgs = [[1, 2], [P - 1, 12345]]
    inp = torch.stack([_t([m[i] for m in msgs]) for i in range(2)])
    assert FT.limbs_to_ints(PM.hash_batch_mxu_ref(inp)) == JM.hash_many_mxu(msgs)
