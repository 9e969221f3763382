"""Experiment: X4's one-thread alternative against the shipped kernel.

The shipped X4 (``csrc/ec_fft.cu``) runs two threads a butterfly, one GLV
half each. The alternative (``csrc/ec_fft_joint.cu``, on no path) runs both
halves in one thread over shared doublings: about 1.4 times less work a
butterfly, a longer chain and half the threads. This script builds the
alternative alone (``nvcc``, the kernel library's flags, into ``_build/``),
runs both on the same inputs at n = 2^10, 2^13 and 2^16 (the scaled inverse
transform that ``ParamsKZG.downsize`` runs, of n random points, inputs from
``utils/ec_fft.transform_inputs``), checks that their affine outputs are
equal, and times each (CUDA events, mean of 5 warm calls, in the order
shipped, joint, joint, shipped). Prints ptxas's registers and spill of
each kernel of the build and one JSON line with the times and the card's
name and power limit. Run on the card:

    python -m circuits_halo2_tpu_torch.scripts.exp_x4_joint
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess

import numpy as np
import torch

from .. import build, native
from ..ops import ec_fft_kernel as EK
from ..ops import field as F
from ..ops import field_torch as FT
from ..ops import ntt as NTT
from ..utils import ec_fft as EC

SIZES = (10, 13, 16)
ITERS = 5
SOURCE = build.CSRC / "ec_fft_joint.cu"


def load() -> tuple[ctypes.CDLL, str]:
    """Build the alternative (if its sources changed) and load it; the
    ptxas log of a fresh build, else empty."""
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for path in sorted(build.CSRC.glob("*.cuh")) + [build.CSRC / "ec_fft.cu", SOURCE]:
        h.update(path.read_bytes())
    out = build.build_dir() / f"x4_joint-{h.hexdigest()[:16]}.so"
    log = ""
    if not out.exists():
        tmp = out.with_suffix(".tmp")
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
        tmp.replace(out)
        log = proc.stderr
    lib = ctypes.CDLL(str(out))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.x4_joint_stage_cuda.argtypes = [vp, vp, vp, i64, i64, i32, i32, vp]
    lib.x4_joint_scale_cuda.argtypes = [vp, vp, vp, i64, i64, i32, vp]
    lib.x4_joint_stage_cuda.restype = lib.x4_joint_scale_cuda.restype = ctypes.c_int
    return lib, log


def joint_ec_fft(lib, x, y, z, digits, scale):
    """The transform through the alternative: the arguments and result of
    ``ops/ec_fft_kernel.ec_fft`` on the card."""
    nb, n = x.shape[1], x.shape[2]
    state = torch.stack([FT.limbs_to_words(c, 0) for c in (x, y, z)]).contiguous()
    beta = FT.limbs_to_words(FT.const_tensor(EK.FQ.const(EK.BETA), x.device, 2), 0)
    digits = digits.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for s in range(n.bit_length() - 1):
        build.check(lib.x4_joint_stage_cuda(state.data_ptr(), digits.data_ptr(), beta.data_ptr(),
                                            n, nb, s, EK.DIGITS, stream), "x4_joint_stage_cuda")
    if scale is not None:
        scale = scale.contiguous()
        build.check(lib.x4_joint_scale_cuda(state.data_ptr(), scale.data_ptr(), beta.data_ptr(),
                                            n, nb, EK.DIGITS, stream), "x4_joint_scale_cuda")
    return tuple(FT.words_to_limbs(state[c], 0) for c in range(3))


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_x4_joint needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    lib, log = load()
    for line in log.splitlines():  # each kernel's registers and spill
        if re.search(r"entry function|spill|registers", line):
            print(line.strip())
    rng = np.random.default_rng(0)
    out = {"card": card}
    for k in SIZES:
        n = 1 << k
        points = native.g1_fixed_base_muls((1, 2), [int(v) for v in rng.integers(1, 1 << 62, n)])
        x4_args = EC.transform_inputs(points, [(F.fr_inv(NTT.omega_for_k(k)), F.fr_inv(n))], dev)
        shipped = EC.jacobian_to_affine(*EK.ec_fft(*x4_args))
        if EC.jacobian_to_affine(*joint_ec_fft(lib, *x4_args)) != shipped:
            raise AssertionError(f"the one-thread alternative differs from X4 at n=2^{k}")
        times = [cuda_ms(lambda: EK.ec_fft(*x4_args), ITERS),
                 cuda_ms(lambda: joint_ec_fft(lib, *x4_args), ITERS),
                 cuda_ms(lambda: joint_ec_fft(lib, *x4_args), ITERS),
                 cuda_ms(lambda: EK.ec_fft(*x4_args), ITERS)]
        out[f"k{k}"] = {"two_thread_ms": [times[0], times[3]], "joint_ms": times[1:3]}
        print(f"n=2^{k}: equal; two threads {times[0]:.3f}, {times[3]:.3f} ms; "
              f"one thread {times[1]:.3f}, {times[2]:.3f} ms ({card})", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
