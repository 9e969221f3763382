"""K4: the Poseidon sponge in the raw-residue domain with every modular
reduction as one integer matrix product -- the tensor-core CUDA kernel and
its plain torch version.

Counterpart of ``poseidon_mxu.py::hash_batch_mxu`` / ``hash_many_mxu`` in
the JAX package. There is no Montgomery factor: every product t (512 bits,
64 bytes t_h) is reduced as

    t == sum_j 2^(8j) S_j (mod p),   S = W @ bytes(t),   W[j][h] = byte j of (2^(8h) mod p)

with ``W`` the (32, 64) byte matrix of ``reduce_weights``, then made
canonical (``csrc/poseidon_mxu.cu`` states the bounds). ``hash_batch_mxu``
takes ``(L, 16, N)`` int64 16-bit limbs of plain residues (any value below
2^256, so raw keccak digests and balance sums go in as they are) and
returns the ``(16, N)`` canonical plain digests. A CPU tensor runs
``hash_batch_mxu_ref``; a CUDA tensor launches the kernel (or raises);
nothing falls back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import build
from . import field as F
from . import field_torch as FT
from . import poseidon as PS
from .poseidon_kernel import capacity

P = F.FR_MOD
NBYTES = 64       # byte planes of a 512-bit product
NOUT = 32         # output byte columns S_j
QDIV = (P >> 224) + 1


def reduce_weights() -> np.ndarray:
    """(32, 64) uint8: W[j][h] = byte j of 2^(8h) mod p."""
    cols = [pow(2, 8 * h, P).to_bytes(NOUT, "little") for h in range(NBYTES)]
    return np.array([[c[j] for c in cols] for j in range(NOUT)], dtype=np.uint8)


# Wide (32 x 32 -> 64) multiplies of K4's steps: the word products of
# bn254_fast.cuh's wide squaring, product and two-product MDS row, and of a
# reduction's canonicalisation (8 for q·p, 4 for the reciprocal's
# multiply-high); a reduction's tensor-core operations (32 x 64
# multiply-adds of 2 operations each).
SQR_WIDE, MUL_WIDE, MUL2_WIDE, REDUCE_WIDE = 36, 64, 128, 12
REDUCE_TENSOR = NOUT * NBYTES * 2
PERM_WIDE = 144 * SQR_WIDE + 72 * MUL_WIDE + 128 * MUL2_WIDE + 344 * REDUCE_WIDE


def ops_per_hash(length: int) -> tuple[int, int]:
    """(wide multiplies, tensor-core operations) of one digest of a
    length-L message. Per permutation: 144 squarings, 72 products and 128
    MDS rows (each a two-product sum), and 344 reductions; per absorbed
    word one more canonicalisation."""
    return length * (PERM_WIDE + REDUCE_WIDE), length * 344 * REDUCE_TENSOR


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_tables(device: str):
    w = torch.tensor(reduce_weights(), dtype=torch.float64, device=device)
    rc = torch.tensor(np.stack([FT.ints_to_limbs(row) for row in PS.ROUND_CONSTANTS]),
                      device=device)  # (64, 16, 2)
    mds = torch.tensor(np.stack([FT.ints_to_limbs(row) for row in PS.MDS]),
                       device=device)  # (2, 16, 2)
    mod = torch.tensor(FT.FR.mod, device=device).reshape(FT.NLIMBS, 1)
    return w, rc, mds, mod


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalised product columns of two (16, N) limb tensors -> (32, N)."""
    n = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    t = torch.zeros((2 * FT.NLIMBS,) + tuple(n), dtype=FT.DTYPE, device=a.device)
    for i in range(FT.NLIMBS):
        t[i : i + FT.NLIMBS].addcmul_(a[i : i + 1], b)
    return t


def _canon(v: torch.Tensor) -> torch.Tensor:
    """(17, N) exact 16-bit limbs of V < 2^268 -> (16, N) canonical V mod p,
    by the kernel's steps: q = floor((V >> 224) / d), V - q·p < 3p, two
    conditional subtractions."""
    _, _, _, mod = _ref_tables(str(v.device))
    q = (v[14] + (v[15] << 16) + (v[16] << 32)) // QDIV
    raw = v[: FT.NLIMBS] - q * mod
    raw[FT.NLIMBS - 1] += v[FT.NLIMBS] << FT.LIMB_BITS
    return FT._reduce_once(FT._reduce_once(raw, mod), mod)


def reduce_ref(t: torch.Tensor) -> torch.Tensor:
    """(32, N) product columns (value < 2^512) -> (16, N) canonical residue:
    byte planes, one matrix product against ``W`` (exact: every sum is below
    2^22, far inside float64), carry, canonicalise."""
    w, _, _, _ = _ref_tables(str(t.device))
    limbs, carry = FT.normalize(t.clone())
    if bool((carry != 0).any()):
        raise ValueError("reduce_ref: value does not fit 512 bits")
    planes = torch.stack([limbs & 0xFF, limbs >> 8], dim=1).reshape(NBYTES, -1)
    s = (w @ planes.to(torch.float64)).to(FT.DTYPE)  # (32, N), S_j < 2^22
    v = torch.zeros((FT.NLIMBS + 1, s.shape[1]), dtype=FT.DTYPE, device=t.device)
    v[: FT.NLIMBS] = s[0::2] + (s[1::2] << 8)
    v, _ = FT.normalize(v)
    return _canon(v)


def mul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod p for (16, N) limbs of values below 2^256."""
    return reduce_ref(_product(a, b))


def canon256_ref(a: torch.Tensor) -> torch.Tensor:
    """(16, N) limbs of any value below 2^256 -> canonical."""
    return _canon(torch.cat([a, torch.zeros_like(a[:1])]))


def _pow5(x: torch.Tensor) -> torch.Tensor:
    x2 = mul_ref(x, x)
    x4 = mul_ref(x2, x2)
    return mul_ref(x4, x)


def permute_mxu_ref(s0: torch.Tensor, s1: torch.Tensor):
    """One permutation on (16, N) canonical plain residues."""
    _, rc, mds, _ = _ref_tables(str(s0.device))
    for r in range(PS.N_ROUNDS):
        full = r < PS.R_FULL // 2 or r >= PS.R_FULL // 2 + PS.R_PARTIAL
        s0 = _pow5(FT.add_mod(s0, rc[r, :, 0:1]))
        s1 = FT.add_mod(s1, rc[r, :, 1:2])
        if full:
            s1 = _pow5(s1)
        n0 = reduce_ref(_product(mds[0, :, 0:1], s0) + _product(mds[0, :, 1:2], s1))
        n1 = reduce_ref(_product(mds[1, :, 0:1], s0) + _product(mds[1, :, 1:2], s1))
        s0, s1 = n0, n1
    return s0, s1


def hash_batch_mxu_ref(inputs: torch.Tensor) -> torch.Tensor:
    """The sponge of ``hash_batch_mxu`` in plain torch, step for step."""
    length, _, n = inputs.shape
    s0 = torch.zeros((FT.NLIMBS, n), dtype=FT.DTYPE, device=inputs.device)
    cap = FT.const_tensor(FT.int_to_limbs(capacity(length)), inputs.device, 2)
    s1 = cap.expand(FT.NLIMBS, n).clone()
    for i in range(length):
        s0, s1 = permute_mxu_ref(FT.add_mod(s0, canon256_ref(inputs[i])), s1)
    return s0


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _words(values) -> np.ndarray:
    """Ints -> (len, 8) little-endian uint32 words."""
    return np.frombuffer(b"".join(int(v).to_bytes(32, "little") for v in values),
                         dtype="<u4").reshape(len(values), 8)


def fragment_weights() -> np.ndarray:
    """``W``ᵀ as the kernel's B fragments of ``mma.m16n8k32`` (k = 64 bytes
    of a product, n = 32 sums): (32 lanes, 16 words) uint32, word
    (ks·4 + nt)·2 + reg of lane 4g + t holding bytes k = 32·ks + 16·reg +
    4t .. + 3 (low byte first) of column n = 8·nt + g."""
    w = reduce_weights()  # (n, k)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    out = np.zeros((32, 2, 4, 2), dtype=np.uint32)
    for ks in range(2):
        for nt in range(4):
            for reg in range(2):
                for e in range(4):
                    k = 32 * ks + 16 * reg + 4 * t + e
                    out[:, ks, nt, reg] |= w[8 * nt + g, k].astype(np.uint32) << (8 * e)
    return np.ascontiguousarray(out.reshape(32, 16))


@functools.lru_cache(maxsize=None)
def kernel_lib():
    """The kernel library with this module's constants loaded."""
    lib = build.cuda_library()
    rc = np.ascontiguousarray(_words([c for row in PS.ROUND_CONSTANTS for c in row]))
    mds = np.ascontiguousarray(_words([c for row in PS.MDS for c in row]))
    wb = fragment_weights()
    build.check(lib.poseidon_mxu_set_constants(rc.ctypes.data, mds.ctypes.data, wb.ctypes.data),
                "poseidon_mxu_set_constants")
    return lib


def hash_batch_mxu(inputs: torch.Tensor) -> torch.Tensor:
    """(L, 16, N) plain residues (< 2^256) -> (16, N) canonical plain digests."""
    if inputs.dim() != 3 or inputs.shape[1] != FT.NLIMBS or inputs.dtype != FT.DTYPE:
        raise ValueError(f"hash_batch_mxu wants (L, 16, N) int64, got "
                         f"{tuple(inputs.shape)} {inputs.dtype}")
    if inputs.device.type == "cpu":
        return hash_batch_mxu_ref(inputs)
    if inputs.device.type != "cuda":
        raise ValueError(f"hash_batch_mxu: unsupported device {inputs.device}")
    lib = kernel_lib()
    length, _, n = inputs.shape
    words = FT.limbs_to_words(inputs, 1)
    out = torch.empty((8, n), dtype=torch.int32, device=inputs.device)
    cap = np.ascontiguousarray(_words([capacity(length)]).reshape(8))
    stream = torch.cuda.current_stream(inputs.device).cuda_stream
    hash_batch_mxu.launches += 1
    build.check(lib.poseidon_mxu_hash_batch_cuda(words.data_ptr(), out.data_ptr(), length, n,
                                                 cap.ctypes.data, stream),
                "poseidon_mxu_hash_batch_cuda")
    return FT.words_to_limbs(out, 0)


hash_batch_mxu.launches = 0


def hash_many_mxu(messages: list[list[int]], device="cuda:0") -> list[int]:
    """Host helper: the digests of N same-length messages of ints."""
    length = len(messages[0])
    inputs = torch.stack([
        torch.as_tensor(FT.ints_to_limbs([m[i] % P for m in messages]), device=device)
        for i in range(length)])
    return FT.limbs_to_ints(hash_batch_mxu(inputs))
