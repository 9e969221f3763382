"""Build and load the port's native code at first use.

Everything compiled lands in ``circuits_halo2_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the hash of its sources and flags, so
a checkout builds what it needs on first call and never loads a binary made
from other sources. Builds write to a temporary name and rename it into
place, so concurrent processes may race without harm.

The CUDA kernels (``csrc/*.cu``) are compiled by ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded through ctypes.
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
CUDA_SOURCES = ("poseidon.cu", "msm_scan.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    for name in ("bn254.cuh",) + CUDA_SOURCES:
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"kernels-{h.hexdigest()[:16]}.so"


def compile_cuda() -> tuple[Path, float, str]:
    """Compile the kernels if needed. Returns (library, seconds, ptxas log);
    seconds is 0.0 and the log empty when the library was already built."""
    out = cuda_library_path()
    if out.exists():
        return out, 0.0, ""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in CUDA_SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stderr


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
            lib.msm_scan_cuda.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i64, vp]
            for fn in (lib.poseidon_set_constants, lib.poseidon_hash_batch_cuda,
                       lib.msm_scan_cuda):
                fn.restype = ctypes.c_int
            _cuda = lib
    return _cuda


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
