"""field_torch against field_jax: Fr and Fq, random batches plus 0, 1 and
p-1. Tolerance: exact (finite-field arithmetic, canonical limbs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circuits_halo2_tpu.ops import field_jax as FJ
from circuits_halo2_tpu_torch import convert
from circuits_halo2_tpu_torch.ops import field_torch as FT

torch.set_num_threads(2)

SPECS = {"fr": (FJ.FR, FT.FR), "fq": (FJ.FQ, FT.FQ)}


def _operands(mod: int, seed: int, n: int = 61):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n)]
    a = [0, 1, mod - 1, mod - 1, 0] + vals
    b = [mod - 1, 0, mod - 1, 1, 1] + vals[::-1]
    return FT.ints_to_limbs(a), FT.ints_to_limbs(b)


def _jax(x):
    return jnp.asarray(x.astype(np.uint32))


def _same(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


BINARY = {
    "mont_mul": (FT.mont_mul, FJ.mont_mul),
    "add_mod": (FT.add_mod, FJ.add_mod),
    "sub_mod": (FT.sub_mod, FJ.sub_mod),
}
UNARY = {
    "mont_sqr": (FT.mont_sqr, FJ.mont_sqr),
    "neg_mod": (FT.neg_mod, FJ.neg_mod),
    "to_mont": (FT.to_mont, FJ.to_mont),
    "from_mont": (FT.from_mont, FJ.from_mont),
    "pow5": (FT.pow5, FJ.pow5),
    "inv_mont": (FT.inv_mont, FJ.inv_mont),
}


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops_match_jax(field, op):
    js, ts = SPECS[field]
    a, b = _operands(ts.mod_int, seed=len(op))
    tfn, jfn = BINARY[op]
    assert _same(tfn(torch.as_tensor(a), torch.as_tensor(b), ts), jfn(_jax(a), _jax(b), js))


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_ops_match_jax(field, op):
    js, ts = SPECS[field]
    a, _ = _operands(ts.mod_int, seed=len(op), n=13 if op == "inv_mont" else 61)
    tfn, jfn = UNARY[op]
    assert _same(tfn(torch.as_tensor(a), ts), jfn(_jax(a), js))


def test_mont_pow_and_predicates():
    a, b = _operands(FT.FR.mod_int, seed=7, n=11)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert _same(FT.mont_pow(ta, 12345), FJ.mont_pow(_jax(a), 12345, FJ.FR))
    assert np.array_equal(FT.is_zero(ta).numpy(), np.asarray(FJ.is_zero(_jax(a))))
    assert np.array_equal(FT.eq(ta, tb).numpy(), np.asarray(FJ.eq(_jax(a), _jax(b))))
    mask = FT.is_zero(ta)
    assert _same(FT.select(mask, ta, tb), FJ.select(FJ.is_zero(_jax(a)), _jax(a), _jax(b)))


def test_batched_broadcast_matches_flat():
    """(16, B, n) against a (16, 1, n) operand equals the flat product."""
    a, b = _operands(FT.FR.mod_int, seed=3, n=59)  # 64 lanes
    ta = torch.as_tensor(a).reshape(16, 4, 16)
    tb = torch.as_tensor(b[:, :16]).reshape(16, 1, 16)
    got = FT.mont_mul(ta, tb)
    want = FT.mont_mul(ta.reshape(16, 64), tb.expand(16, 4, 16).reshape(16, 64))
    assert torch.equal(got.reshape(16, 64), want)


def test_host_conversions_and_words():
    rng = np.random.default_rng(5)
    xs = [0, 1, FT.FR.mod_int - 1] + [int.from_bytes(rng.bytes(32), "little") for _ in range(9)]
    limbs = FT.ints_to_limbs(xs)
    assert np.array_equal(limbs, FJ.ints_to_limbs(xs).astype(np.int64))
    assert FT.limbs_to_ints(limbs) == xs
    assert FT.limbs_to_int(limbs[:, 5]) == xs[5]
    assert torch.equal(convert.limbs16_from_jax(FJ.ints_to_limbs(xs), "cpu"), torch.as_tensor(limbs))
    t = torch.as_tensor(limbs)
    words = FT.limbs_to_words(t, 0)
    assert words.dtype == torch.int32 and words.shape == (8, len(xs))
    assert torch.equal(FT.words_to_limbs(words, 0), t)
    stacked = torch.stack([t, t.flip(-1)])  # limbs on dim 1
    assert torch.equal(FT.words_to_limbs(FT.limbs_to_words(stacked, 1), 1), stacked)
