"""Experiment: per-multiply costs of the tensor-core reduction on the card.

Counterpart of the JAX package's ``scripts/exp_poseidon_mxu.py``. Each
variant runs ITERS dependent iterations per lane of one templated kernel
(``csrc/poseidon_mxu.cu``, K5), so the per-iteration cost is the loop body:

  vpu_mul   -- the CIOS Montgomery multiply of ``csrc/bn254.cuh`` (CUDA cores)
  boundary  -- the tensor-core reduce step alone (t = v + v·2^256, v = t mod p)
  mxu_mul   -- the CUDA-core wide product plus the tensor-core reduce
  bcast     -- the u32 row-broadcast probe ``acc + acc * acc[j % 18]`` on (18, M·128)
  check     -- K6: one tensor-core-reduced multiply of 4 random 248-bit
               values, held against Python ints

Times are the JAX script's dual-ITERS difference (64 and 320 iterations,
CUDA events, mean of ``--reps`` launches each), so fixed launch costs
cancel. Run on the card:

    python -m circuits_halo2_tpu_torch.scripts.exp_poseidon_mxu [variant ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .. import build
from ..ops import field as F
from ..ops import field_torch as FT
from ..ops import poseidon_mxu as PM

P = F.FR_MOD
VARIANTS = {"vpu_mul": 0, "boundary": 1, "mxu_mul": 2, "bcast": 3}
CHECK = 4
ROWS = 18            # rows of the bcast probe (the TPU kernel's 18 limbs)
LANES = 64 * 8 * 128  # TILES x SUB x LANE of the JAX script
ITERS_LO, ITERS_HI = 64, 320


def make_inputs(variant: str, lanes: int = LANES, seed: int = 0, device="cuda:0"):
    """(x, y): canonical (16, lanes) limbs for the field variants; (18, lanes)
    int64 values below 2^15 (the JAX script's limbs) for bcast."""
    rng = np.random.default_rng(seed)
    if variant == "bcast":
        x = torch.as_tensor(rng.integers(0, 1 << 15, size=(ROWS, lanes), dtype=np.int64),
                            device=device)
        return x, x
    vals = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(lanes)]
            for _ in range(2)]
    return tuple(torch.as_tensor(FT.ints_to_limbs(v), device=device) for v in vals)


def ops_per_iter(variant: str) -> tuple[int, int]:
    """(wide multiplies, tensor-core operations) of one iteration of one
    lane: a CIOS product is 136 wide multiplies, a wide product 64
    (``bn254_fast.cuh``), a tensor-core reduction 32 x 64 multiply-adds plus
    12 wide multiplies to make it canonical; ``bcast``'s 18 32-bit
    multiply-adds count as 9."""
    red = PM.REDUCE_WIDE
    return {"vpu_mul": (136, 0), "boundary": (red, PM.REDUCE_TENSOR),
            "mxu_mul": (PM.MUL_WIDE + red, PM.REDUCE_TENSOR), "bcast": (9, 0)}[variant]


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def _bcast_ref(x: torch.Tensor, iters: int) -> torch.Tensor:
    acc = x.clone()
    mask = 0xFFFFFFFF
    for j in range(iters):
        b = acc[j % ROWS]
        lo, hi = b & 0xFFFF, b >> 16  # acc * b mod 2^32 without int64 overflow
        acc = (acc + acc * lo + (((acc * hi) & 0xFFFF) << 16)) & mask
    return acc


def run_ref(variant: str, x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of ``run``."""
    if variant == "bcast":
        return _bcast_ref(x, iters)
    if variant == "boundary":
        v = x
        for _ in range(iters):
            v = PM.reduce_ref(torch.cat([v, v]))
        return v
    if variant not in ("vpu_mul", "mxu_mul"):
        raise ValueError(f"unknown variant {variant}")
    mul = FT.mont_mul if variant == "vpu_mul" else PM.mul_ref
    for _ in range(iters):
        x, y = mul(x, y), x
    return FT.add_mod(x, y)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _to_kernel(code: int, t: torch.Tensor) -> torch.Tensor:
    """The kernel's layout: (8, N) int32 words, or (18, N) u32 bits for bcast."""
    return _u32(t) if code == VARIANTS["bcast"] else FT.limbs_to_words(t, 0)


def _launch_words(code: int, xw: torch.Tensor, yw: torch.Tensor, iters: int) -> torch.Tensor:
    """One launch on arrays already in the kernel's layout; returns the same."""
    lib = PM.kernel_lib()
    out = torch.empty_like(xw)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    wrapper = mxu_mul_once if code == CHECK else run
    wrapper.launches += 1
    build.check(lib.poseidon_mxu_probe_cuda(code, xw.data_ptr(), yw.data_ptr(), out.data_ptr(),
                                            xw.shape[1], iters, stream),
                "poseidon_mxu_probe_cuda")
    return out


def _launch(code: int, x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    PM.kernel_lib()  # builds the kernels, or raises, before any conversion
    out = _launch_words(code, _to_kernel(code, x), _to_kernel(code, y), iters)
    if code == VARIANTS["bcast"]:
        return out.to(FT.DTYPE) & 0xFFFFFFFF
    return FT.words_to_limbs(out, 0)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 -> the same bits as contiguous int32."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32).contiguous()


def _check_args(x: torch.Tensor, y: torch.Tensor, rows: int, what: str):
    for t in (x, y):
        if t.dim() != 2 or t.shape[0] != rows or t.dtype != FT.DTYPE:
            raise ValueError(f"{what} wants ({rows}, N) int64, got {tuple(t.shape)} {t.dtype}")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"{what}: x and y differ in shape or device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def run(variant: str, x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    """K5: ``iters`` dependent iterations of ``variant`` per lane. x, y are
    (16, N) canonical limbs, or (18, N) values below 2^32 for bcast."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant}")
    _check_args(x, y, ROWS if variant == "bcast" else FT.NLIMBS, "run")
    if x.device.type == "cpu":
        return run_ref(variant, x, y, iters)
    return _launch(VARIANTS[variant], x, y, iters)


run.launches = 0


def mxu_mul_once(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K6: x·y mod p through one tensor-core reduction, (16, N) limbs."""
    _check_args(x, y, FT.NLIMBS, "mxu_mul_once")
    if x.device.type == "cpu":
        return PM.mul_ref(x, y)
    return _launch(CHECK, x, y, 1)


mxu_mul_once.launches = 0


def check_mxu_mul_exact(device="cuda:0") -> int:
    """K6's probe: 4 random 248-bit products in one tile of 8 x 128 lanes,
    against Python ints. Returns the largest limb error (0) or raises."""
    rng = np.random.default_rng(1)
    xs = [int.from_bytes(rng.bytes(31), "little") for _ in range(4)]
    ys = [int.from_bytes(rng.bytes(31), "little") for _ in range(4)]
    pad = [0] * (8 * 128 - 4)
    x = torch.as_tensor(FT.ints_to_limbs(xs + pad), device=device)
    y = torch.as_tensor(FT.ints_to_limbs(ys + pad), device=device)
    got = mxu_mul_once(x, y)
    want = torch.as_tensor(FT.ints_to_limbs([a * b % P for a, b in zip(xs, ys)] + pad),
                           device=device)
    err = int((got - want).abs().max())
    if err:
        raise AssertionError(f"mxu_mul exactness: limbs differ by up to {err}")
    return err


def time_variant(variant: str, device="cuda:0", reps: int = 5, lanes: int = LANES) -> dict:
    """The dual-ITERS timing of one variant on the card (CUDA events),
    launches alone: the inputs are put in the kernel's layout once, outside
    the timed loop."""
    code = VARIANTS[variant]
    x, y = (_to_kernel(code, t) for t in make_inputs(variant, lanes, 0, device))
    ms = {}
    for iters in (ITERS_LO, ITERS_HI):
        _launch_words(code, x, y, iters)  # warm-up
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            _launch_words(code, x, y, iters)
        end.record()
        torch.cuda.synchronize(device)
        ms[iters] = start.elapsed_time(end) / reps
    ns = (ms[ITERS_HI] - ms[ITERS_LO]) * 1e6 / ((ITERS_HI - ITERS_LO) * lanes)
    return {"variant": variant, "lanes": lanes, "ms_lo": ms[ITERS_LO], "ms_hi": ms[ITERS_HI],
            "ns_per_elem_iter": ns}


def run_variants(variants, device="cuda:0", reps: int = 5) -> list[dict]:
    """``check`` and the timed variants, in order; one result dict each."""
    out = []
    for v in variants:
        if v == "check":
            out.append({"variant": "check", "max_abs_err": check_mxu_mul_exact(device)})
        else:
            out.append(time_variant(v, device, reps))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", choices=["check", *VARIANTS],
                    help="default: all of them, check first")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_poseidon_mxu needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({card or 'nvidia-smi gave nothing'})",
          flush=True)
    for r in run_variants(args.variants or ["check", *VARIANTS], device, args.reps):
        if r["variant"] == "check":
            print("mxu_mul exactness: OK", flush=True)
        else:
            print(f"{r['variant']:10s} @{ITERS_LO} {r['ms_lo']:9.3f} ms  @{ITERS_HI} "
                  f"{r['ms_hi']:9.3f} ms  per-elem-iter {r['ns_per_elem_iter']:8.4f} ns", flush=True)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
