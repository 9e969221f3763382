"""Time K1-K6 at their paths' shapes on one GPU, for one checkout.

    python circuits_halo2_tpu_torch/scripts/time_kernels.py [--root DIR] [--k 13,14]

Imports ``circuits_halo2_tpu_torch`` from ``--root`` (default: the checkout
that holds this file), so one call can time two checkouts of the package
on one card in turns (parent, change, change, parent). Builds that
checkout's kernels, then times each wrapper with CUDA events (one warm
launch, then the mean of ``--iters``): K1 at 2^20 messages for L = 2 and 3,
K2 at 2^20 states, and K3 at each ``--k`` (n = 2^k points, L =
``msm._seg_chunk_len(n)``, 128 at k = 13) for a commitment batch of 3
columns of random scalars, for the largest keygen batch
(``msm.BATCH_LANE_BUDGET``: 16 columns at k = 13) and for 3 columns of
which 90 % of the scalars are 0. Then K4 at 2^20 messages for L = 2 and
3 (on the same messages as K1, as plain residues), the 2^20 tree root
through K4 (its 21 launches, each fenced by CUDA events, summed; digests
and balances from ``--seed``), K5's ``boundary`` and ``mxu_mul`` at 2^16
lanes x 64 iterations (wrapper time, and ns per element-iteration by the
experiment's dual-ITERS difference) and K6's one reduced multiply at
1024 lanes. Prints one JSON line with the times and the card's name and
power limit. Inputs are random canonical values from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def cuda_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k4_root_ms(torch, np, DT, PM, args) -> tuple[float, int]:
    """The root of a 2^20-entry tree through K4: the summed CUDA-event time
    of its launches, mean over ``--iters`` roots after a warm one, and the
    launches of one."""
    rng = np.random.default_rng(args.seed)
    n = 1 << 20
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    balances = rng.integers(0, 1 << 40, size=(n, 1), dtype=np.uint64)
    hash_batch_mxu = PM.hash_batch_mxu
    spans = []

    def timed(inputs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = hash_batch_mxu(inputs)
        end.record()
        spans.append((start, end))
        return got

    timed.launches = 0  # hash_batch_mxu counts its launches on the module's name
    PM.hash_batch_mxu = timed
    try:
        DT.tree_root_mxu(digests, balances, "cuda:0")
        spans.clear()
        for _ in range(args.iters):
            DT.tree_root_mxu(digests, balances, "cuda:0")
        torch.cuda.synchronize()
    finally:
        PM.hash_batch_mxu = hash_batch_mxu
    return sum(s.elapsed_time(e) for s, e in spans) / args.iters, len(spans) // args.iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--k", default="13")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_kernels.py needs a CUDA device")
    from circuits_halo2_tpu_torch import build, native
    from circuits_halo2_tpu_torch.merkle import device_tree as DT
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
    from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    build.cuda_library()
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def canonical(*shape):  # random values below 0x3064 * 2^240 < p (Fr and Fq)
        limbs = torch.randint(0, 1 << 16, (16, *shape), generator=gen, device=dev)
        limbs[15] %= 0x3064
        return limbs

    out = {"root": str(Path(args.root).resolve()), "card": card}
    n = 1 << 20
    for length in (2, 3):
        inp = canonical(length, n).movedim(0, 1).contiguous()
        out[f"k1_L{length}"] = cuda_ms(torch, lambda: PK.hash_batch(inp), args.iters)
        out[f"k4_L{length}"] = cuda_ms(torch, lambda: PM.hash_batch_mxu(inp), args.iters)
    a, b = canonical(n), canonical(n)
    out["k2"] = cuda_ms(torch, lambda: PK.permute(a, b), args.iters)

    rng = np.random.default_rng(args.seed)
    for k in (int(v) for v in args.k.split(",")):
        npts = 1 << k
        points = native.g1_fixed_base_muls((1, 2), [int(v) for v in rng.integers(1, 1 << 62, npts)])
        xs, ys, valid = M.precompute_bases(points, dev)
        L = M._seg_chunk_len(npts)
        for batch, zeros in ((3, 0.0), (M.BATCH_LANE_BUDGET // npts, 0.0), (3, 0.9)):
            scal = canonical(batch, npts)
            scal[:, torch.rand(batch, npts, generator=gen, device=dev) < zeros] = 0
            digits = M.digits_from_mont(scal)
            perm = torch.argsort(digits, dim=-1, stable=True)
            seg = torch.gather(digits, -1, perm)
            pxy = torch.cat([xs, ys], dim=0)[:, perm]
            px, py, pv = pxy[:16], pxy[16:], valid[perm]
            tag = f"k3_k{k}_b{batch}" + (f"_z{round(zeros * 100)}" if zeros else "")
            out[tag] = cuda_ms(torch, lambda: MK.segmented_scan(px, py, pv, seg, L), args.iters)
    out["k4_root"], out["k4_root_launches"] = k4_root_ms(torch, np, DT, PM, args)
    for variant in ("boundary", "mxu_mul"):
        x, y = EXP.make_inputs(variant, EXP.LANES, args.seed, dev)
        out[f"k5_{variant}"] = cuda_ms(torch, lambda: EXP.run(variant, x, y, EXP.ITERS_LO),
                                       args.iters)
        out[f"k5_{variant}_ns"] = EXP.time_variant(variant, dev, args.iters)["ns_per_elem_iter"]
    x, y = EXP.make_inputs("mxu_mul", 8 * 128, args.seed, dev)
    out["k6"] = cuda_ms(torch, lambda: EXP.mxu_mul_once(x, y), args.iters)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
