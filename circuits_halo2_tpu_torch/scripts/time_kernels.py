"""Time K1-K6, X4, X1 and X0c at their paths' shapes on one GPU, for one checkout.

    python circuits_halo2_tpu_torch/scripts/time_kernels.py [--root DIR] [--k 13,14]
        [--kernels k1,k2,k3,k4,k5,k6,x4,x1,x0c,x1plan]

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
1024 lanes. X4 at n = 2^10, 2^13 and 2^16: the scaled inverse transform
that ``ParamsKZG.downsize`` runs (omega^-1, scale n^-1) of n random points,
its inputs built by that checkout's own ``utils/ec_fft.transform_inputs``
and timed through its ``ops/ec_fft_kernel.ec_fft`` (one launch a stage and
one for the scale). X1 through ``ntt.ntt`` (and ``intt``) at (16, 8, 2^16), the
k=13 prover's extended domain, (16, 2, 2^19), k=17's, and (16, 4, 2^13), and
at 2^10 to 2^12 over 8 rows; ``x1plan`` (not in the default, and only
where the checkout has ``ntt.plan``) times X1's one-pass sizes at the k=11
prove's batches in the library's plan against builds of ``csrc/ntt.cu`` with
another (``X1_VARIANTS``: one pass without clusters, two passes); X0c through ``field_torch.inv_mont`` at (16, 1,
3, 1), ``batch_inv_dev``'s, and at 2^16. For X1 and X0c each entry is the
device time a call (``torch.profiler``'s CUDA kernel durations summed over
``--iters`` calls, every kernel the call launches: the parent's gather and
stages too), its launches, and the wrapper's time (CUDA events around
``--iters`` back-to-back calls, host time included). ``--kernels`` names
the kernels to time (default all). Prints one JSON line with the times and
the card's name and power limit. Inputs are random canonical values from
``--seed``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

X4_K = (10, 13, 16)  # X4's sizes: both downsizes of the path, and the card full
# Profiles taken before giving up on one that misses kernels (seen after
# a few in one process)
PROFILE_TRIES = 8


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


def device_ms(torch, fn, iters: int) -> tuple[float, float]:
    """(ms of CUDA kernel time a call, kernels a call) over ``iters`` calls
    of ``fn`` under ``torch.profiler`` after a warm one. A profile that
    recorded no kernel, or a count that is no multiple of ``iters`` (both
    seen in a process that had profiled before), is taken again, up to
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not e.name().startswith(("Memcpy", "Memset"))]
        if kernels and len(kernels) % iters == 0:
            return (sum(e.end_ns() - e.start_ns() for e in kernels) / 1e6 / iters,
                    len(kernels) / iters)
    raise RuntimeError(f"torch.profiler recorded no whole set of kernels in {PROFILE_TRIES} "
                       "tries")


def timed_call(torch, fn, iters: int) -> dict:
    """Device time and launches a call, and the wrapper's time a call."""
    ms, launches = device_ms(torch, fn, iters)
    return {"device_ms": ms, "launches": launches, "wrapper_ms": cuda_ms(torch, fn, iters)}


# X1's one-pass sizes at the batches the entry_16 k=11 prove hands them (its
# lagrange_to_coeff of 9, 19 and 20 columns), and 8 rows at 2^10 and 2^11
X1_PLAN_SHAPES = ((9, 11), (19, 11), (20, 11), (8, 11), (8, 10))
# The plans compared with the library's: -D settings of csrc/ntt.cu
X1_VARIANTS = {"no_cluster": "-DX1_MAX_CLUSTER_LOG=0", "two_pass": "-DX1_ONE_PASS_MAX_LOG=0"}


def x1_variant(build, root: Path, define: str):
    """The checkout's csrc/ntt.cu built alone with one plan setting changed
    by ``define``, loaded through ctypes (its ntt_cuda has the library's
    arguments)."""
    import ctypes
    import hashlib

    src = root / "circuits_halo2_tpu_torch" / "csrc" / "ntt.cu"
    tag = hashlib.sha256(define.encode() + src.read_bytes()).hexdigest()[:12]
    so = build.build_dir() / f"ntt-variant-{tag}.so"
    if not so.exists():
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, define, "-shared", "-o", str(so),
                        str(src)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ntt_cuda.argtypes = [vp, vp, vp, vp, vp, i32, vp, i32, i64, i64, i32, vp]
    lib.ntt_cuda.restype = ctypes.c_int
    return lib


def x1_plans(torch, NTT, build, root: Path, canonical, iters: int) -> dict:
    """At each of ``X1_PLAN_SHAPES``, the library's plan (one pass, a row a
    block or a cluster's) against the ``X1_VARIANTS`` builds (one pass
    without clusters; two passes), each a ``timed_call`` of the bare
    transform, their limbs required equal; and the library's plan."""
    libs = {name: x1_variant(build, root, d) for name, d in X1_VARIANTS.items()}
    out = {}
    for rows, k in X1_PLAN_SHAPES:
        n, omega = 1 << k, NTT.omega_for_k(k)
        a = canonical(1, rows, n)
        tw = NTT._powers(n, omega, str(a.device))
        stream = torch.cuda.current_stream(a.device).cuda_stream

        def variant(lib):
            res = torch.empty_like(a)
            scratch = torch.empty(rows * n * 8, dtype=torch.int32, device=a.device)
            build.check(lib.ntt_cuda(a.data_ptr(), res.data_ptr(), scratch.data_ptr(),
                                     tw.data_ptr(), 0, 0, 0, 0, rows, n, k, stream), "variant")
            return res

        want = NTT.ntt_passes(a, omega, n)
        tag = f"x1_k{k}x{rows}"
        out[f"{tag}_plan"] = NTT.plan(n, rows)
        out[f"{tag}_library"] = timed_call(torch, lambda: NTT.ntt_passes(a, omega, n), iters)
        for name, lib in libs.items():
            if not torch.equal(variant(lib), want):
                raise RuntimeError(f"X1's {name} build differs from the library at {tag}")
            out[f"{tag}_{name}"] = timed_call(torch, lambda: variant(lib), iters)
    return out


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
    ap.add_argument("--kernels", default="k1,k2,k3,k4,k5,k6,x4,x1,x0c")
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
    from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
    from circuits_halo2_tpu_torch.ops import field as F
    from circuits_halo2_tpu_torch.ops import field_torch as FT
    from circuits_halo2_tpu_torch.ops import msm as M
    from circuits_halo2_tpu_torch.ops import msm_kernel as MK
    from circuits_halo2_tpu_torch.ops import ntt as NTT
    from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
    from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
    from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP
    from circuits_halo2_tpu_torch.utils import ec_fft as EC

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
    kernels = set(args.kernels.split(","))
    n = 1 << 20
    for length in (2, 3) if kernels & {"k1", "k4"} else ():
        inp = canonical(length, n).movedim(0, 1).contiguous()
        out[f"k1_L{length}"] = cuda_ms(torch, lambda: PK.hash_batch(inp), args.iters)
        out[f"k4_L{length}"] = cuda_ms(torch, lambda: PM.hash_batch_mxu(inp), args.iters)
    if "k2" in kernels:
        a, b = canonical(n), canonical(n)
        out["k2"] = cuda_ms(torch, lambda: PK.permute(a, b), args.iters)

    rng = np.random.default_rng(args.seed)
    for k in (int(v) for v in args.k.split(",")) if "k3" in kernels else ():
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
    if "k4" in kernels:
        out["k4_root"], out["k4_root_launches"] = k4_root_ms(torch, np, DT, PM, args)
    for variant in ("boundary", "mxu_mul") if "k5" in kernels else ():
        x, y = EXP.make_inputs(variant, EXP.LANES, args.seed, dev)
        out[f"k5_{variant}"] = cuda_ms(torch, lambda: EXP.run(variant, x, y, EXP.ITERS_LO),
                                       args.iters)
        out[f"k5_{variant}_ns"] = EXP.time_variant(variant, dev, args.iters)["ns_per_elem_iter"]
    if "k6" in kernels:
        x, y = EXP.make_inputs("mxu_mul", 8 * 128, args.seed, dev)
        out["k6"] = cuda_ms(torch, lambda: EXP.mxu_mul_once(x, y), args.iters)
    for k in X4_K if "x4" in kernels else ():
        npts = 1 << k
        points = native.g1_fixed_base_muls((1, 2), [int(v) for v in rng.integers(1, 1 << 62, npts)])
        omega_inv = F.fr_inv(NTT.omega_for_k(k))
        x4_args = EC.transform_inputs(points, [(omega_inv, F.fr_inv(npts))], dev)
        before = EK.ec_fft.launches
        out[f"x4_k{k}"] = cuda_ms(torch, lambda: EK.ec_fft(*x4_args), args.iters)
        out[f"x4_k{k}_launches"] = (EK.ec_fft.launches - before) // (args.iters + 1)
    for rows, k in ((8, 16), (2, 19), (4, 13), (8, 10), (8, 11), (8, 12)) if "x1" in kernels else ():
        n, omega = 1 << k, NTT.omega_for_k(k)
        a = canonical(1, rows, n)
        out[f"x1_k{k}x{rows}"] = timed_call(torch, lambda: NTT.ntt(a, omega), args.iters)
        if k == 16:
            out[f"x1_k{k}x{rows}_intt"] = timed_call(torch, lambda: NTT.intt(a, omega), args.iters)
    if "x1plan" in kernels and hasattr(NTT, "plan"):
        out.update(x1_plans(torch, NTT, build, Path(args.root), canonical, args.iters))
    for shape in ((1, 3, 1), (1 << 16,)) if "x0c" in kernels else ():
        z = canonical(*shape)
        tag = "x0c_" + "x".join(map(str, shape))
        out[tag] = timed_call(torch, lambda: FT.inv_mont(z), args.iters)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
