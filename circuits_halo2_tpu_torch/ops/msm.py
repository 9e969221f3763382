"""Multi-scalar multiplication: the device-resident Pippenger of
``circuits_halo2_tpu/ops/msm.py`` on torch limb tensors.

Points are affine or Jacobian triples over Fq, each coordinate a
``(16, *batch)`` int64 Montgomery tensor (``ops/field_torch``); Z = 0 is
the point at infinity. The bucket method per commitment batch:

1. 8-bit windows of the de-Montgomeried scalars -> digits (B, 32, n).
2. A stable argsort by digit per (msm, window) and one fused gather of both
   coordinates make every bucket one contiguous segment.
3. K3 (``ops/msm_kernel.segmented_scan``): chunk-local serial segmented
   sums of mixed adds; then a log-depth scan carries chunk totals across
   chunk boundaries, folded in only at the bucket ends.
4. The window sum  sum_b b * B_b: with b = 16g + r on a 16 x 16 bucket grid
   it is  16 * sum_g g * G_g + sum_r r * R_r, where G_g sums grid row g and
   R_r grid column r -- 32 four-level pairwise trees per window.
5. The host's native Pippenger folds the 32 x 32 partial sums with their
   weights times 2^(8w) into the final point (``_combine_windows_host``).

The same torch code runs on any device; only K3 dispatches on it (plain
scan on CPU, the CUDA kernel on a GPU), so the CPU tests exercise the
card's algorithm. Under a rank mesh (``parallel/auto``) steps 1-4 run on
each rank's block of the lanes and the partials are summed over ranks
before step 5 (``parallel/msm_sharded``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from . import field_torch as FT
from . import msm_kernel as MK
from .. import native
from ..parallel import auto

FQ = FT.FQ

WINDOW = 8
NWIN = -(-256 // WINDOW)  # windows covering 256 bits
NBUCKET = 1 << WINDOW
# Cap B·n per bucket-stage batch: the sorted gathers hold (32, B, NWIN, n)
# int64 limbs, 2 GB at B·n = 2^17.
BATCH_LANE_BUDGET = 1 << 17


def _mm(a, b):
    return FT.mont_mul(a, b, FQ)


def _add(a, b):
    return FT.add_mod(a, b, FQ)


def _sub(a, b):
    return FT.sub_mod(a, b, FQ)


def _dbl_f(a):  # 2a
    return FT.add_mod(a, a, FQ)


def jac_double(p):
    """Jacobian doubling, a=0 curve (dbl-2009-l). Z = 0 stays at infinity."""
    x, y, z = p
    a = _mm(x, x)
    b = _mm(y, y)
    c = _mm(b, b)
    xb = _add(x, b)
    d = _sub(_sub(_mm(xb, xb), a), c)
    d = _dbl_f(d)
    e = _add(_add(a, a), a)
    f = _mm(e, e)
    x3 = _sub(f, _dbl_f(d))
    c8 = _dbl_f(_dbl_f(_dbl_f(c)))
    y3 = _sub(_mm(e, _sub(d, x3)), c8)
    z3 = _dbl_f(_mm(y, z))
    return (x3, y3, z3)


def _select_double(use_dbl, p, out):
    """Replace lanes of ``out`` by 2p where ``use_dbl``; the doubling is
    computed only if some lane needs it (the result is the same)."""
    if not bool(use_dbl.any()):
        return out
    dbl = jac_double(p)
    return tuple(FT.select(use_dbl, d, o) for d, o in zip(dbl, out))


def jac_add(p, q):
    """Complete Jacobian addition (add-2007-bl) with case handling."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = _mm(z1, z1)
    z2z2 = _mm(z2, z2)
    u1 = _mm(x1, z2z2)
    u2 = _mm(x2, z1z1)
    s1 = _mm(_mm(y1, z2), z2z2)
    s2 = _mm(_mm(y2, z1), z1z1)
    h = _sub(u2, u1)
    rr = _dbl_f(_sub(s2, s1))
    i = _mm(_dbl_f(h), _dbl_f(h))
    j = _mm(h, i)
    v = _mm(u1, i)
    x3 = _sub(_sub(_mm(rr, rr), j), _dbl_f(v))
    y3 = _sub(_mm(rr, _sub(v, x3)), _dbl_f(_mm(s1, j)))
    z3 = _dbl_f(_mm(_mm(z1, z2), h))

    p_inf = FT.is_zero(z1)
    q_inf = FT.is_zero(z2)
    h_zero = FT.is_zero(h)
    r_zero = FT.is_zero(rr)
    sel = FT.select
    use_dbl = h_zero & r_zero & ~p_inf & ~q_inf
    to_inf = h_zero & ~r_zero & ~p_inf & ~q_inf  # P + (-P)
    x3, y3, z3 = _select_double(use_dbl, p, (x3, y3, z3))
    z3 = sel(to_inf, torch.zeros_like(z3), z3)
    x3 = sel(p_inf, x2, sel(q_inf, x1, x3))
    y3 = sel(p_inf, y2, sel(q_inf, y1, y3))
    z3 = sel(p_inf, z2, sel(q_inf, z1, z3))
    return (x3, y3, z3)


def jac_madd(p, q):
    """Mixed addition: Jacobian p + affine q (madd-2007-bl), q = (x2, y2,
    valid) with implicit Z2 = 1 and valid False meaning infinity."""
    x1, y1, z1 = p
    x2, y2, valid = q
    z1z1 = _mm(z1, z1)
    u2 = _mm(x2, z1z1)
    s2 = _mm(_mm(y2, z1), z1z1)
    h = _sub(u2, x1)
    hh = _mm(h, h)
    i = _dbl_f(_dbl_f(hh))
    j = _mm(h, i)
    rr = _dbl_f(_sub(s2, y1))
    v = _mm(x1, i)
    x3 = _sub(_sub(_mm(rr, rr), j), _dbl_f(v))
    y3 = _sub(_mm(rr, _sub(v, x3)), _dbl_f(_mm(y1, j)))
    z1h = _add(z1, h)
    z3 = _sub(_sub(_mm(z1h, z1h), z1z1), hh)

    p_inf = FT.is_zero(z1)
    h_zero = FT.is_zero(h)
    r_zero = FT.is_zero(rr)
    q_inf = ~valid
    one = FT.const_tensor(FQ.one_mont, x2.device, x2.dim()).expand_as(x2)
    sel = FT.select
    use_dbl = h_zero & r_zero & ~p_inf & ~q_inf
    to_inf = h_zero & ~r_zero & ~p_inf & ~q_inf
    x3, y3, z3 = _select_double(use_dbl, p, (x3, y3, z3))
    z3 = sel(to_inf, torch.zeros_like(z3), z3)
    x3 = sel(p_inf, x2, x3)
    y3 = sel(p_inf, y2, y3)
    z3 = sel(p_inf, one, z3)
    x3 = sel(q_inf, x1, x3)
    y3 = sel(q_inf, y1, y3)
    z3 = sel(q_inf, z1, z3)
    return (x3, y3, z3)


# ---------------------------------------------------------------------------
# Bucket stage
# ---------------------------------------------------------------------------

def _seg_chunk_len(n: int) -> int:
    """Serial chunk length of the two-level segmented scan (the reference's
    default: longer chunks mean fewer chunk totals to carry)."""
    return max(16, min(512, n // 64))


def _roll_scan(p, direction: int, seg=None):
    """Hillis-Steele log-depth Jacobian sum scan along the last axis.

    direction=+1: inclusive prefix sums; -1: inclusive suffix sums. With
    ``seg`` only lanes of the same segment are combined."""
    n = p[0].shape[-1]
    idx = torch.arange(n, device=p[0].device)
    d = 1
    while d < n:
        prev = tuple(torch.roll(c, direction * d, dims=-1) for c in p)
        valid = idx >= d if direction > 0 else idx < n - d
        if seg is not None:
            valid = valid & (torch.roll(seg, direction * d, dims=-1) == seg)
        p = jac_add(p, (prev[0], prev[1], torch.where(valid, prev[2], 0)))
        d *= 2
    return p


def _segmented_sum_parts(px, py, pvalid, seg):
    """Two-level segmented bucket accumulation over sorted affine points.

    Returns ``(local, carry, carry_seg, L)``: K3's chunk-local inclusive
    segmented sums (16, ..., n), the Jacobian sum carried into each chunk
    by its leading segment (16, ..., n/L), and that segment's digit."""
    n = seg.shape[-1]
    L = _seg_chunk_len(n)
    nchunk = n // L
    local = MK.segmented_scan(px, py, pvalid, seg, L)
    last_vals = tuple(c.reshape(c.shape[:-1] + (nchunk, L))[..., -1] for c in local)
    last_seg = seg.reshape(seg.shape[:-1] + (nchunk, L))[..., -1]
    inc = _roll_scan(last_vals, +1, seg=last_seg)
    carry = tuple(torch.roll(c, 1, dims=-1) for c in inc)
    first = torch.arange(nchunk, device=seg.device) == 0
    carry_seg = torch.where(first, -1, torch.roll(last_seg, 1, dims=-1))
    return local, carry, carry_seg, L


def _tree_sum_last(p):
    """Pairwise Jacobian sum along the (power-of-two) last axis -> size 1."""
    while p[0].shape[-1] > 1:
        half = p[0].shape[-1] // 2
        p = jac_add(tuple(c[..., :half] for c in p), tuple(c[..., half:] for c in p))
    return p


SPLIT = 1 << (WINDOW // 2)  # the bucket grid is SPLIT x SPLIT
# weight of each per-window partial sum: 16·g for row sums G_g, r for column sums R_r
PARTIAL_WEIGHTS = [SPLIT * g for g in range(SPLIT)] + list(range(SPLIT))


def _pippenger_windows(xs, ys, valid, digits):
    """Bucket stage up to the per-window partial sums.

    xs, ys: (16, n) affine Montgomery Fq; valid: (n,) bool; digits:
    (nmsm, NWIN, n) window digits. Returns a (16, nmsm, NWIN, 2·SPLIT)
    Jacobian triple S with  window_w = sum_i PARTIAL_WEIGHTS[i]·S[..., w, i]."""
    n = xs.shape[1]
    dev = xs.device
    perm = torch.argsort(digits, dim=-1, stable=True)  # (B, W, n)
    seg = torch.gather(digits, -1, perm)
    pxy = torch.cat([xs, ys], dim=0)[:, perm]  # one fused gather: (32, B, W, n)
    px, py = pxy[: FT.NLIMBS], pxy[FT.NLIMBS :]
    pv = valid[perm]

    local, carry, carry_seg, L = _segmented_sum_parts(px, py, pv, seg)

    # segment ends -> (B, W, NBUCKET) table of end positions; the extra last
    # column is a trash lane for non-end positions, n marks an empty bucket
    ends = torch.cat([seg[..., 1:] != seg[..., :-1],
                      torch.ones(seg.shape[:-1] + (1,), dtype=torch.bool, device=dev)], dim=-1)
    write_col = torch.where(ends, seg, NBUCKET)
    pos_idx = torch.arange(n, device=dev).expand(seg.shape)
    table = torch.full(seg.shape[:-1] + (NBUCKET + 1,), n, dtype=torch.int64, device=dev)
    table.scatter_(-1, write_col, pos_idx)
    bucket_pos = table[..., :NBUCKET]

    gidx = bucket_pos.clamp(0, n - 1).unsqueeze(0).expand((FT.NLIMBS,) + bucket_pos.shape)
    bx, by, bz = (torch.gather(c, -1, gidx) for c in local)
    buckets = torch.arange(NBUCKET, device=dev)
    live = (bucket_pos < n) & (buckets > 0)  # drop empty buckets and bucket 0
    bz = torch.where(live, bz, 0)

    # fold each chunk's carried-in sum into the bucket whose end it holds
    chunk_ix = (bucket_pos // L).clamp(0, carry_seg.shape[-1] - 1)
    cs_g = torch.gather(carry_seg, -1, chunk_ix)
    cidx = chunk_ix.unsqueeze(0).expand((FT.NLIMBS,) + chunk_ix.shape)
    cx, cy, cz = (torch.gather(c, -1, cidx) for c in carry)
    cz = torch.where(live & (cs_g == buckets), cz, 0)
    bsum = jac_add((bx, by, bz), (cx, cy, cz))  # (16, B, W, NBUCKET)

    # sum_b b·B_b = 16·sum_g g·G_g + sum_r r·R_r over the 16 x 16 bucket grid
    grid = tuple(c.reshape(c.shape[:-1] + (SPLIT, SPLIT)) for c in bsum)
    rows_cols = tuple(torch.cat([c, c.transpose(-1, -2)], dim=-2) for c in grid)
    return tuple(c[..., 0] for c in _tree_sum_last(rows_cols))


def _combine_windows_host(acc) -> list:
    """(16, B, NWIN, 2·SPLIT) Jacobian partial sums -> B host affine points.

    point_b = sum_{w, i} PARTIAL_WEIGHTS[i]·2^(8w)·S[b, w, i], by the native
    host Pippenger over each row's small points."""
    q = F.FQ_MOD
    ax, ay, az = (FT.from_mont_ints(c.reshape(FT.NLIMBS, -1), FQ) for c in acc)
    nb = acc[0].shape[1]
    out = []
    i = 0
    for _ in range(nb):
        pts, scal = [], []
        for w in range(NWIN):
            for weight in PARTIAL_WEIGHTS:
                if az[i] and weight:
                    zi = pow(az[i], -1, q)
                    zi2 = zi * zi % q
                    pts.append((ax[i] * zi2 % q, ay[i] * zi2 % q * zi % q))
                    scal.append(weight << (WINDOW * w))
                i += 1
        out.append(native.g1_msm(pts, scal) if pts else None)
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

_bases_cache: dict = {}


def _pad_n(n_real: int) -> int:
    """Point count rounded up to a power of two >= 256 (so the chunked scan
    always has chunks of length >= 4). Padded lanes are invalid."""
    return max(256, 1 << (n_real - 1).bit_length())


def precompute_bases(points, device) -> tuple:
    """Affine host points -> cached (xs, ys, valid) tensors on ``device``,
    zero-padded to ``_pad_n(len(points))`` lanes. The cache holds the list
    itself, so an id is never reused while its entry lives."""
    key = (id(points), len(points), str(torch.device(device)))
    hit = _bases_cache.get(key)
    if hit is not None and hit[0] is points:
        return hit[1]
    n = _pad_n(len(points))
    pad = [None] * (n - len(points))
    pts = list(points) + pad
    xs = FT.to_mont_limbs([0 if p is None else p[0] for p in pts], FQ)
    ys = FT.to_mont_limbs([0 if p is None else p[1] for p in pts], FQ)
    valid = np.array([p is not None for p in pts], dtype=bool)
    out = (torch.as_tensor(xs, device=device), torch.as_tensor(ys, device=device),
           torch.as_tensor(valid, device=device))
    if len(_bases_cache) >= 8:
        _bases_cache.clear()
    _bases_cache[key] = (points, out)
    return out


def digits_from_mont(scal_mont: torch.Tensor) -> torch.Tensor:
    """(16, B, m) Montgomery Fr scalars -> (B, NWIN, m) int64 WINDOW-bit
    digits, little-endian window order."""
    canon = FT.from_mont(scal_mont)
    per_limb = FT.LIMB_BITS // WINDOW
    wins = [
        (canon[w // per_limb] >> (WINDOW * (w % per_limb))) & (NBUCKET - 1)
        for w in range(NWIN)
    ]
    return torch.stack(wins, dim=1)


def _batch_chunk(nmsm: int, n: int) -> int:
    b = nmsm
    while b > 1 and b * n > BATCH_LANE_BUDGET:
        b = (b + 1) // 2
    return b


def _commit_dev(xs, ys, valid, scal_mont):
    """(16, B, m) Montgomery scalar columns -> per-window, per-bit sums."""
    n = xs.shape[1]
    digits = digits_from_mont(scal_mont)  # (B, NWIN, m)
    m = digits.shape[-1]
    if m < n:
        digits = torch.nn.functional.pad(digits, (0, n - m))
    return _pippenger_windows(xs, ys, valid, digits)


def msm_commit_dev_async(points, scal_mont: torch.Tensor):
    """Dispatch the bucket stage for B commitments of device-resident
    Montgomery scalar columns (16, B, m <= len(points)) and return a
    ``finish()`` that materialises the B host affine points (or None).

    On a GPU the launches are queued on the current stream and only
    ``finish()`` waits, so the caller can enqueue more work first. Under
    an active mesh (``_active_mesh``) each rank runs its block of the lanes
    (``parallel/msm_sharded``) and the partials are gathered here, at
    dispatch, in the same order on every rank."""
    if scal_mont.dim() != 3 or scal_mont.shape[2] > len(points):
        raise ValueError(f"scal_mont must be (16, B, m <= {len(points)}), got {tuple(scal_mont.shape)}")
    b = int(scal_mont.shape[1])
    xs, ys, valid = precompute_bases(points, scal_mont.device)
    n = int(xs.shape[1])
    chunk_b = _batch_chunk(b, n)
    commit = _commit_dev
    mesh = _active_mesh(n)
    if mesh is not None:
        from ..parallel import msm_sharded

        commit = functools.partial(msm_sharded.commit_sharded_device, mesh)
    accs = [commit(xs, ys, valid, scal_mont[:, lo : lo + chunk_b])
            for lo in range(0, b, chunk_b)]

    def finish():
        out = []
        for acc in accs:
            out.extend(_combine_windows_host(acc))
        return out

    return finish


def _active_mesh(n: int):
    """The mesh to shard an n-lane MSM over, or None: none is active, or n
    does not split into equal blocks of at least 256 lanes (the chunked
    scan's minimum)."""
    mesh = auto.get_mesh()
    if mesh is None or n % mesh.size or n // mesh.size < 256:
        return None
    return mesh


def msm_commit_dev(points, scal_mont: torch.Tensor) -> list:
    """Batched MSM of device-resident Montgomery scalar columns -> B host
    affine points."""
    return msm_commit_dev_async(points, scal_mont)()


def msm_auto_batch(points, scalar_rows, device) -> list:
    """MSMs of host-int scalar rows over one base set, through the device
    Pippenger on ``device``."""
    m = max(len(r) for r in scalar_rows)
    flat = [v for r in scalar_rows for v in list(r) + [0] * (m - len(r))]
    limbs = FT.to_mont_limbs(flat).reshape(FT.NLIMBS, len(scalar_rows), m)
    return msm_commit_dev(points, torch.as_tensor(limbs, device=device))


def msm_auto(points, scalars, device):
    """One MSM of host-int scalars (see ``msm_auto_batch``)."""
    return msm_auto_batch(points, [scalars], device)[0]
