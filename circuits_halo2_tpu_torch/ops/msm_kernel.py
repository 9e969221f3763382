"""K3: the Pippenger bucket scan -- hand-written CUDA kernel and its plain
torch version.

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
"""

from __future__ import annotations

import torch

from .. import build
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
    build.check(
        lib.msm_scan_cuda(sg.data_ptr(), vs.data_ptr(), px.data_ptr(), py.data_ptr(),
                          outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                          points, L, stream),
        "msm_scan_cuda",
    )
    return tuple(outs)


segmented_scan.launches = 0
