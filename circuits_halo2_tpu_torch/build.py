"""Build and load the port's native code at first use.

Everything compiled lands in ``circuits_halo2_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the hash of its sources and flags, so
a checkout builds what it needs on first call and never loads a binary made
from other sources. Builds write to a temporary name and rename it into
place, so concurrent processes may race without harm.

The CUDA kernels (``csrc/*.cu``) are compiled by ``nvcc`` for ``sm_90a``,
one ``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded through ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
CUDA_SOURCES = ("poseidon.cu", "msm_scan.cu", "poseidon_mxu.cu", "ec_fft.cu", "field_ops.cu",
                "ntt.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_cuda: ctypes.CDLL | None = None


def build_dir() -> Path:
    d = PKG / "_build"
    d.mkdir(exist_ok=True)
    return d


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def cuda_library_path() -> Path:
    """Path of the compiled kernel library for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / name for name in CUDA_SOURCES]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return build_dir() / f"kernels-{h.hexdigest()[:16]}.so"


def compile_cuda() -> tuple[Path, float, str]:
    """Compile the kernels if needed. Returns (library, seconds, ptxas log);
    seconds is 0.0 and the log empty when the library was already built."""
    out = cuda_library_path()
    if out.exists():
        return out, 0.0, ""
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{Path(s).stem}.o") for s in CUDA_SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(CUDA_SOURCES, objs)]
    logs = []
    for s, proc in zip(CUDA_SOURCES, procs):
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            for other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed on {s} ({proc.returncode}):\n{err}")
        logs.append(err)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, timeout=300)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, "".join(logs)


def cuda_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _cuda
    with _lock:
        if _cuda is None:
            path, _, _ = compile_cuda()
            lib = ctypes.CDLL(str(path))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.poseidon_set_constants.argtypes = [vp, vp]
            lib.poseidon_hash_batch_cuda.argtypes = [vp, vp, i32, i64, vp, vp]
            lib.poseidon_permute_cuda.argtypes = [vp, vp, vp, vp, i64, vp]
            lib.msm_scan_cuda.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i32, vp]
            lib.poseidon_mxu_set_constants.argtypes = [vp, vp, vp]
            lib.poseidon_mxu_hash_batch_cuda.argtypes = [vp, vp, i32, i64, vp, vp]
            lib.poseidon_mxu_probe_cuda.argtypes = [i32, vp, vp, vp, i64, i32, vp]
            lib.ec_fft_stage_cuda.argtypes = [vp, vp, vp, i64, i64, i32, i32, vp]
            lib.ec_fft_scale_cuda.argtypes = [vp, vp, vp, i64, i64, i32, vp]
            lib.field_mont_mul_cuda.argtypes = [vp, vp, vp, vp, i32, i32, vp]
            lib.field_linear_cuda.argtypes = [i32, vp, vp, vp, vp, i32, i32, vp]
            lib.field_pow_cuda.argtypes = [vp, vp, vp, i32, vp, i32, i32, vp]
            lib.field_inv_cuda.argtypes = [vp, vp, vp, i32, vp, i32, vp]
            lib.ntt_cuda.argtypes = [vp, vp, vp, vp, vp, i32, vp, i32, i64, i64, i32, vp]
            lib.ntt_plan_cuda.argtypes = [i64, i32, vp]
            for fn in (lib.poseidon_set_constants, lib.poseidon_hash_batch_cuda,
                       lib.poseidon_permute_cuda, lib.msm_scan_cuda,
                       lib.poseidon_mxu_set_constants, lib.poseidon_mxu_hash_batch_cuda,
                       lib.poseidon_mxu_probe_cuda, lib.ec_fft_stage_cuda,
                       lib.ec_fft_scale_cuda, lib.field_mont_mul_cuda, lib.field_linear_cuda,
                       lib.field_pow_cuda, lib.field_inv_cuda, lib.ntt_cuda,
                       lib.ntt_plan_cuda):
                fn.restype = ctypes.c_int
            _cuda = lib
    return _cuda


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
