"""Number-theoretic transform over Fr -- host reference and batched torch path.

Counterpart of ``circuits_halo2_tpu/ops/ntt.py``: ``ntt(a, omega)`` computes
out[i] = sum_j a[j]·omega^(i·j) along the last axis of a ``(16, *batch, n)``
Montgomery limb tensor; ``intt`` is ``ntt(a, omega^-1)`` scaled by n^-1.

``transform`` is the general entry the polynomial domain uses: the input may
hold fewer lanes than the transform (the rest taken as zero), and a per-lane
(or constant) factor may be applied to the input and to the output, so that
a coset or n^-1 scale costs no pass of its own. On a CUDA tensor it is X1
(``csrc/ntt.cu``, ``ntt_passes``): the transform in one launch up to 2^11
points and two above (four-step, sub-transforms in shared memory, natural
order in and out), against one cached table of omega^e in packed 32-bit
words. On a CPU tensor, or inside ``field_torch.plain()``,
``transform_ref`` runs the unfused sequence in plain torch: the input factor
(``mont_mul``), the zero lanes, ``ntt_ref`` (a bit-reversal gather and
log2(n) radix-2 DIT stages, each a reshape plus one batched mont_mul against
that stage's twiddles and the add and subtract) and the output factor. Every
output is canonical, so the limbs are the same.

With a mesh active (``parallel/auto``) a transform of n >= 2^12 points
(and n >= size^2) runs as the four-step ``parallel/ntt_sharded``, the JAX
package's routing, with the factors as X0a launches around it; the result
is the same.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import build
from . import field as F
from . import field_torch as FT
from ..parallel import auto


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt_host(a: list[int], omega: int) -> list[int]:
    """Iterative radix-2 DIT NTT on Python ints (reference path)."""
    n = len(a)
    p = F.FR_MOD
    rev = bit_reverse_indices(n)
    out = [a[rev[i]] for i in range(n)]
    for s in range(n.bit_length() - 1):
        half = 1 << s
        step = F.fr_pow(omega, n >> (s + 1))
        for start in range(0, n, 2 * half):
            w = 1
            for j in range(half):
                u = out[start + j]
                v = out[start + half + j] * w % p
                out[start + j] = (u + v) % p
                out[start + half + j] = (u - v) % p
                w = w * step % p
    return out


def intt_host(a: list[int], omega: int) -> list[int]:
    n_inv = F.fr_inv(len(a))
    return [x * n_inv % F.FR_MOD for x in ntt_host(a, F.fr_inv(omega))]


def omega_for_k(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr (halo2 domain omega)."""
    return F.fr_pow(F.FR_ROOT_OF_UNITY, 1 << (F.FR_TWO_ADICITY - k))


# ---------------------------------------------------------------------------
# Factors and tables in X1's layout: packed (L, 8) 32-bit words
# ---------------------------------------------------------------------------

class Lanes:
    """Montgomery factors, one a lane or (with one lane) a constant, that
    ``transform`` applies on load or on store: ``limbs`` (16, L) for the
    plain version, ``words`` their packed (L, 8) form for X1 (made on first
    use, then kept)."""

    def __init__(self, limbs: torch.Tensor):
        self.limbs = limbs
        self._words = None

    @property
    def words(self) -> torch.Tensor:
        if self._words is None:  # one element's 32 bytes contiguous
            self._words = FT.limbs_to_words(self.limbs, 0).T.contiguous()
        return self._words

    def lanes(self, count: int, ndim: int) -> torch.Tensor:
        """The first ``count`` factors (the constant for one lane) shaped
        (16, 1, ..., count) against an ``ndim``-axis tensor."""
        t = self.limbs if self.limbs.shape[1] == 1 else self.limbs[:, :count]
        return t.reshape((FT.NLIMBS,) + (1,) * (ndim - 2) + (-1,))


@functools.lru_cache(maxsize=64)
def const_lanes(value: int, device: str) -> Lanes:
    """The constant ``value`` (an Fr element, made Montgomery) as ``Lanes``."""
    return Lanes(FT.const_tensor(FT.FR.const(value), device, 2))


def _powers_words(n: int, omega: int) -> np.ndarray:
    """(n, 8) int32 words of omega^e R mod p, e < n."""
    p = F.FR_MOD
    v, vals = (1 << 256) % p, []
    for _ in range(n):
        vals.append(v.to_bytes(32, "little"))
        v = v * omega % p
    return np.frombuffer(bytearray(b"".join(vals)), dtype="<i4").reshape(n, 8)


@functools.lru_cache(maxsize=32)
def _powers(n: int, omega: int, device: str) -> torch.Tensor:
    """X1's table: omega^e for e < n, packed, on ``device`` (cached)."""
    return torch.as_tensor(_powers_words(n, omega), device=device)


@functools.lru_cache(maxsize=64)
def _ref_tables(n: int, omega: int, device: str):
    """``ntt_ref``'s tables: the bit-reversal permutation and each stage's
    Montgomery twiddles, stage s (half = 2^s) a (16, half) view of one
    (16, n - 1) table at columns half - 1 .. 2 half - 2."""
    rev = torch.as_tensor(bit_reverse_indices(n), device=device)
    ws = []
    for s in range(n.bit_length() - 1):
        half = 1 << s
        step = F.fr_pow(omega, n >> (s + 1))
        stage = [1] * half
        for j in range(1, half):
            stage[j] = stage[j - 1] * step % F.FR_MOD
        ws += stage
    flat = torch.as_tensor(FT.to_mont_limbs(ws), device=device)
    return rev, [flat[:, (1 << s) - 1 : (2 << s) - 1] for s in range(n.bit_length() - 1)]


# ---------------------------------------------------------------------------
# The transforms
# ---------------------------------------------------------------------------

# The JAX package's threshold, so that the same transforms shard: below it
# the all-to-all and the gathers are judged to cost more than one device
# doing the whole transform (not measured on the port).
SHARD_THRESHOLD = 1 << 12

# X1 runs one pass (whole rows in shared memory, a block's or a cluster's)
# up to 2^11 points, the most a block's shared memory holds with every
# stage's twiddles, and two passes of at most 2^11-point sub-transforms up
# to 2^22 (csrc/ntt.cu's constants of the same names).
ONE_PASS_MAX_LOG = 11
MAX_LOGN = 22


def _shard_mesh(n: int):
    """The mesh to shard an n-point transform over, or None: none is
    active, n is below ``SHARD_THRESHOLD``, or the four-step blocks do not
    split over its ranks (which needs n >= size^2)."""
    mesh = auto.get_mesh()
    if mesh is None or n < SHARD_THRESHOLD:
        return None
    from ..parallel import ntt_sharded

    return mesh if ntt_sharded.split(n, mesh.size) is not None else None


def transform(a: torch.Tensor, omega: int, n: int | None = None, in_scale: Lanes | None = None,
              out_scale: Lanes | None = None) -> torch.Tensor:
    """out[k] = so(k) · sum_j si(j)·a[j]·omega^(j k), k < n, along the last
    axis of a (16, *batch, n_in) Montgomery limb tensor, n_in <= n (lanes
    n_in .. n - 1 taken as zero; n defaults to n_in), si / so the factors of
    ``in_scale`` / ``out_scale`` (1 where None). X1 on a CUDA tensor, over
    the active mesh when ``_shard_mesh`` gives one."""
    n = int(a.shape[-1]) if n is None else int(n)
    mesh = _shard_mesh(n)
    if mesh is not None:
        from ..parallel import ntt_sharded

        return _unfused(a, n, in_scale, out_scale,
                        lambda x: ntt_sharded.ntt_sharded_batched(mesh, x, omega))
    if not FT.on_card(a):
        return transform_ref(a, omega, n, in_scale, out_scale)
    return ntt_passes(a, omega, n, in_scale, out_scale)


def ntt(a: torch.Tensor, omega: int) -> torch.Tensor:
    """NTT along the last axis of a (16, *batch, n) Montgomery limb tensor;
    over the active mesh when ``_shard_mesh`` gives one."""
    return transform(a, omega)


def intt(a: torch.Tensor, omega: int) -> torch.Tensor:
    """Inverse NTT (the n^-1 scale applied as the output is stored)."""
    n = int(a.shape[-1])
    return transform(a, F.fr_inv(omega), out_scale=const_lanes(F.fr_inv(n), str(a.device)))


def _ntt_device(a: torch.Tensor, omega: int) -> torch.Tensor:
    """The single-device transform: X1 on a CUDA tensor, ``ntt_ref`` on a
    CPU tensor (``parallel/ntt_sharded``'s local blocks)."""
    if not FT.on_card(a):
        return ntt_ref(a, omega)
    return ntt_passes(a, omega, int(a.shape[-1]))


def _unfused(a, n, in_scale, out_scale, core):
    """The factors as products around ``core``, the zero lanes as padding."""
    if in_scale is not None:
        a = FT.mont_mul(a, in_scale.lanes(int(a.shape[-1]), a.dim()))
    if n > a.shape[-1]:
        a = torch.nn.functional.pad(a, (0, n - int(a.shape[-1])))
    x = core(a)
    if out_scale is not None:
        x = FT.mont_mul(x, out_scale.lanes(n, x.dim()))
    return x


@FT.plain_version
def transform_ref(a: torch.Tensor, omega: int, n: int | None = None,
                  in_scale: Lanes | None = None, out_scale: Lanes | None = None) -> torch.Tensor:
    """``transform`` in plain torch, on any device: the unfused sequence."""
    n = int(a.shape[-1]) if n is None else int(n)
    return _unfused(a, n, in_scale, out_scale, lambda x: ntt_ref(x, omega))


@FT.plain_version
def ntt_ref(a: torch.Tensor, omega: int) -> torch.Tensor:
    """The plain torch single-device transform, on any device."""
    n = int(a.shape[-1])
    rev, tws = _ref_tables(n, omega, str(a.device))
    x = a.index_select(-1, rev)
    lead = x.shape[:-1]
    for s, tw in enumerate(tws):
        half = 1 << s
        xg = x.reshape(lead + (n // (2 * half), 2, half))
        u = xg[..., 0, :]
        v = FT.mont_mul(xg[..., 1, :], tw.reshape((FT.NLIMBS,) + (1,) * (u.dim() - 2) + (half,)))
        x = torch.stack([FT.add_mod(u, v), FT.sub_mod(u, v)], dim=-2).reshape(lead + (n,))
    return x


def _factor(scale: Lanes | None, count: int, device) -> tuple[int, int]:
    """(pointer, step) of a factor for the kernel: step 0 for a constant,
    1 per lane; (0, 0) for none."""
    if scale is None:
        return 0, 0
    w = scale.words
    if w.device != device or 1 < w.shape[0] < count:
        raise ValueError(f"ntt_passes: {w.shape[0]} factors on {w.device} for {count} lanes "
                         f"on {device}")
    return w.data_ptr(), int(w.shape[0] != 1)


def ntt_passes(a: torch.Tensor, omega: int, n: int, in_scale: Lanes | None = None,
               out_scale: Lanes | None = None) -> torch.Tensor:
    """X1: ``transform`` of every row of the (16, *batch, n_in) limbs ``a`` on
    the card, in one launch for n <= 2^ONE_PASS_MAX_LOG and two above
    (``csrc/ntt.cu``; a strided ``a`` is made contiguous first). Returns a
    new contiguous (16, *batch, n) tensor; ``launches`` counts the launches."""
    n_in = int(a.shape[-1])
    if a.dtype != FT.DTYPE or a.dim() < 2 or a.shape[0] != FT.NLIMBS:
        raise ValueError("ntt: a must be (16, ..., n) int64 limbs")
    if n < 1 or n & (n - 1) or n > 1 << MAX_LOGN or not 1 <= n_in <= n:
        raise ValueError(f"ntt: {n_in} input lanes for {n} points (a power of two up to "
                         f"2^{MAX_LOGN})")
    lib = build.cuda_library()
    x = a.contiguous()
    out = torch.empty(tuple(a.shape[:-1]) + (n,), dtype=FT.DTYPE, device=a.device)
    rows = x[0].numel() // n_in
    if rows == 0:
        return out
    logn = n.bit_length() - 1
    passes = 1 if logn <= ONE_PASS_MAX_LOG else 2
    scratch = torch.empty(rows * n * 8 if passes == 2 else 8, dtype=torch.int32, device=a.device)
    tw = _powers(n, omega % F.FR_MOD, str(a.device))
    si, si_step = _factor(in_scale, n_in, a.device)
    so, so_step = _factor(out_scale, n, a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ntt_passes.launches += passes
    build.check(lib.ntt_cuda(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), tw.data_ptr(),
                             si, si_step, so, so_step, rows, n_in, logn, stream), "ntt_cuda")
    return out


ntt_passes.launches = 0


def plan(n: int, rows: int) -> list[dict]:
    """The launches ``ntt_passes`` makes for ``rows`` rows of n points on the
    current card: each one's kind (one pass, pass A or pass B), lines a
    block, blocks a cluster, threads a block and blocks."""
    desc = (ctypes.c_int64 * 10)()
    count = build.cuda_library().ntt_plan_cuda(rows, n.bit_length() - 1, desc)
    kinds = ("one pass", "pass A", "pass B")
    return [{"kind": kinds[desc[5 * i]], "lines": 1 << desc[5 * i + 1],
             "cluster": 1 << desc[5 * i + 2], "threads": desc[5 * i + 3],
             "blocks": desc[5 * i + 4]} for i in range(count)]
