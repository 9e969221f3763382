"""K3: the Pippenger bucket scan -- hand-written CUDA kernel and its plain
torch version; and X2, the window combine that follows it on the card.

Counterpart of ``circuits_halo2_tpu/ops/msm_pallas.py::_scan_pallas`` (and
of phase 1 of ``ops/msm.py::_segmented_sum_parts``). Points are sorted by
window digit; every chunk of L consecutive points is scanned serially with
mixed Jacobian + affine adds, the accumulator restarting (Z = 0) wherever
the digit changes, and the canonical Jacobian local sum is emitted after
every step.

``segmented_scan(px, py, pvalid, seg, L)`` takes ``(16, *batch, n)`` int64
Montgomery Fq coordinates, ``(*batch, n)`` validity and digits, and returns
three ``(16, *batch, n)`` tensors. A CPU tensor runs ``segmented_scan_ref``;
a CUDA tensor launches ``csrc/msm_scan.cu`` (or raises).

``window_combine(x, y, z)`` (X2, ``csrc/msm_combine.cu``) takes the bucket
stage's ``(16, B, NWIN, 2·SPLIT)`` Jacobian window partials on a CUDA
device and returns each commitment's affine point as a ``(B, 17)`` int64
row: X's and Y's eight 32-bit words, plain and canonical, and 1 (17 zeros
at infinity). It has no plain version here: a CPU tensor takes the host
fold, ``ops/msm._combine_windows_host``.
"""

from __future__ import annotations

import torch

from .. import build
from ..utils import tracing as TR
from . import field_torch as FT

def _lanes(px: torch.Tensor, L: int) -> int:
    n = px.shape[-1]
    if n % L:
        raise ValueError(f"point count {n} is not a multiple of the chunk length {L}")
    return px[0].numel() // L


@FT.plain_version
def segmented_scan_ref(px, py, pvalid, seg, L: int):
    """Plain torch chunk-local segmented scan (same outputs as the kernel)."""
    from . import msm

    lanes = _lanes(px, L)
    xs = px.reshape(FT.NLIMBS, lanes, L)
    ys = py.reshape(FT.NLIMBS, lanes, L)
    vs = pvalid.reshape(lanes, L)
    sg = seg.reshape(lanes, L)
    x = torch.zeros((FT.NLIMBS, lanes), dtype=FT.DTYPE, device=px.device)
    y = torch.zeros_like(x)
    z = torch.zeros_like(x)
    cseg = torch.full((lanes,), -1, dtype=sg.dtype, device=px.device)
    out = [torch.empty((FT.NLIMBS, lanes, L), dtype=FT.DTYPE, device=px.device)
           for _ in range(3)]
    for t in range(L):
        eseg = sg[:, t]
        z = torch.where((eseg == cseg).unsqueeze(0), z, 0)
        x, y, z = msm.jac_madd((x, y, z), (xs[:, :, t], ys[:, :, t], vs[:, t]))
        for o, c in zip(out, (x, y, z)):
            o[:, :, t] = c
        cseg = eseg
    return tuple(o.reshape(px.shape) for o in out)


def segmented_scan(px, py, pvalid, seg, L: int):
    """Chunk-local segmented bucket sums; see the module docstring."""
    for name, a in (("px", px), ("py", py)):
        if a.dtype != FT.DTYPE or a.shape[0] != FT.NLIMBS:
            raise ValueError(f"segmented_scan: {name} must be (16, ..., n) int64")
    if py.shape != px.shape or pvalid.shape != px.shape[1:] or seg.shape != px.shape[1:]:
        raise ValueError("segmented_scan: mismatched shapes")
    if px.device.type == "cpu":
        return segmented_scan_ref(px, py, pvalid, seg, L)
    if px.device.type != "cuda":
        raise ValueError(f"segmented_scan: unsupported device {px.device}")
    lib = build.cuda_library()
    points = _lanes(px, L) * L
    px, py = px.contiguous(), py.contiguous()
    sg = seg.to(torch.int64).contiguous()
    vs = pvalid.to(torch.bool).contiguous()
    outs = [torch.empty_like(px) for _ in range(3)]
    stream = torch.cuda.current_stream(px.device).cuda_stream
    segmented_scan.launches += 1
    if TR.on:
        TR.count("kernel", "K3", launches=1, points=points)
    build.check(
        lib.msm_scan_cuda(sg.data_ptr(), vs.data_ptr(), px.data_ptr(), py.data_ptr(),
                          outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                          points, L, stream),
        "msm_scan_cuda",
    )
    return tuple(outs)


segmented_scan.launches = 0


X2_PARTIALS = (32, 32)  # ops/msm.py's NWIN windows x 2·SPLIT partials
X2_OUT = 17  # int64s a commitment: X's words, Y's words, 1 where finite


def window_combine(x, y, z) -> torch.Tensor:
    """X2: fold each commitment's window partials into its affine point on
    the card; see the module docstring."""
    for name, a in (("x", x), ("y", y), ("z", z)):
        if (a.dtype != FT.DTYPE or a.dim() != 4 or a.shape[0] != FT.NLIMBS
                or tuple(a.shape[2:]) != X2_PARTIALS):
            raise ValueError(f"window_combine: {name} must be (16, B, 32, 32) int64, "
                             f"got {a.dtype} {tuple(a.shape)}")
    if y.shape != x.shape or z.shape != x.shape or y.device != x.device or z.device != x.device:
        raise ValueError("window_combine: mismatched shapes or devices")
    if x.device.type != "cuda":
        raise ValueError(f"window_combine: the kernel needs a CUDA tensor, got {x.device}")
    lib = build.cuda_library()
    b = int(x.shape[1])
    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    out = torch.empty((b, X2_OUT), dtype=torch.int64, device=x.device)
    if b:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        window_combine.launches += 1
        if TR.on:
            TR.count("kernel", "X2", launches=1, commitments=b)
        build.check(lib.msm_combine_cuda(x.data_ptr(), y.data_ptr(), z.data_ptr(), out.data_ptr(),
                                         b, FT._r3_words(FT.FQ.mod_int), stream),
                    "msm_combine_cuda")
    return out


window_combine.launches = 0
