"""Frozen copy of ``circuits_halo2_tpu_torch/ops/field.py`` for the benchmark's
reference (it imports nothing of the port; later changes to the port do
not move it).

BN254 scalar/base field arithmetic — host-side (Python int) reference path.

Scalar field Fr (circuit field, ``Fp`` in the reference) and base field Fq.
Mirrors the semantics of halo2curves ``bn256::Fr`` as used by the reference
(`zk_prover/src/merkle_sum_tree/utils/operation_helpers.rs:5-17`,
`zk_prover/src/chips/poseidon/poseidon_params.rs` ``Fr::from_raw``):

- values are integers mod p,
- ``to_repr``/``from_repr`` are 32-byte little-endian,
- ``from_raw`` takes 4 little-endian 64-bit limbs (plain value, not Montgomery).

The device path (vectorized Montgomery limb arithmetic) lives in
``field_torch.py``; this module is the scalar reference and the source of
all field constants used there. ``batch_inv`` runs in Python here.
"""

from __future__ import annotations

# BN254 (alt_bn128) scalar field modulus — the circuit field.
FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
# BN254 base field modulus — coordinates of G1/G2 points.
FQ_MOD = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47

# 2-adicity of Fr - 1: p - 1 = 2^28 * t with t odd.
FR_TWO_ADICITY = 28
# Generator of the multiplicative group of Fr (halo2curves uses 7).
FR_GENERATOR = 7
# Primitive 2^28-th root of unity: 7^((p-1)/2^28) mod p.
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR_MOD - 1) >> FR_TWO_ADICITY, FR_MOD)

# Montgomery constants for the 256-bit limb representation (R = 2^256).
R_BITS = 256
FR_R = (1 << R_BITS) % FR_MOD
FR_R2 = (FR_R * FR_R) % FR_MOD
FR_R3 = (FR_R2 * FR_R) % FR_MOD
# N' = -p^{-1} mod 2^256, used by full-product Montgomery reduction.
FR_NPRIME = (-pow(FR_MOD, -1, 1 << R_BITS)) % (1 << R_BITS)

FQ_R = (1 << R_BITS) % FQ_MOD
FQ_R2 = (FQ_R * FQ_R) % FQ_MOD
FQ_NPRIME = (-pow(FQ_MOD, -1, 1 << R_BITS)) % (1 << R_BITS)


def fr(x: int) -> int:
    """Reduce an integer into Fr."""
    return x % FR_MOD


def fq(x: int) -> int:
    return x % FQ_MOD


def fr_add(a: int, b: int) -> int:
    return (a + b) % FR_MOD


def fr_sub(a: int, b: int) -> int:
    return (a - b) % FR_MOD


def fr_mul(a: int, b: int) -> int:
    return (a * b) % FR_MOD


def fr_neg(a: int) -> int:
    return (-a) % FR_MOD


def fr_inv(a: int) -> int:
    if a % FR_MOD == 0:
        raise ZeroDivisionError("inversion of zero in Fr")
    return pow(a, -1, FR_MOD)


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, FR_MOD)


def fr_from_raw(limbs: tuple[int, int, int, int]) -> int:
    """halo2curves ``Fr::from_raw``: 4 LE u64 limbs → field value."""
    v = limbs[0] | (limbs[1] << 64) | (limbs[2] << 128) | (limbs[3] << 192)
    return v % FR_MOD


def fr_to_bytes(a: int) -> bytes:
    """``Fr::to_bytes`` — 32-byte little-endian canonical repr."""
    return int(a % FR_MOD).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    """``Fr::from_bytes`` — little-endian; caller must ensure canonicity."""
    v = int.from_bytes(b, "little")
    if v >= FR_MOD:
        raise ValueError("non-canonical Fr repr")
    return v


def fr_from_bytes_wide(b: bytes) -> int:
    """``Fr::from_uniform_bytes`` / from_bytes_wide — 64 LE bytes mod p."""
    return int.from_bytes(b, "little") % FR_MOD


def batch_inv(values: list[int], mod: int = FR_MOD) -> list[int]:
    """Montgomery batch inversion (one inversion for n elements).

    Zero entries are passed through as zero, matching halo2's
    ``batch_invert`` convention for skipped elements.
    """
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v != 0 else 1) % mod
    inv_all = pow(prefix[n], -1, mod)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v == 0:
            out[i] = 0
        else:
            out[i] = prefix[i] * inv_all % mod
            inv_all = inv_all * v % mod
    return out
