"""The port's handle on the reference's host C++ runtime.

Binds the C functions of ``csrc/fieldcc.cpp`` (host Pippenger ``g1_msm``,
fixed-base muls for SRS setup, the Poseidon sponge, Fr batch inversion and
keccak), the port's copy of the reference's host C++, and the port's own
witness fill of the MstInclusion circuit (``mst_witness_fill``). It is
compiled with portable flags (no ``-march=native``) into the port's build
directory, under a name keyed by the source's hash, so a stale or foreign
binary is never loaded and nothing tracked by git is written.

The library is required: a missing compiler raises instead of falling back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from . import build

SRC = Path(__file__).resolve().parent / "csrc" / "fieldcc.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_ABI_VERSION = 6

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compile() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = build.build_dir() / f"fieldcc-{digest}.so"
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=600)
        os.replace(tmp, out)  # atomic: concurrent builders race safely
    return out


def get() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            lib.fieldcc_abi_version.restype = ctypes.c_int
            if lib.fieldcc_abi_version() != _ABI_VERSION:
                raise RuntimeError("fieldcc.cpp ABI version changed")
            _configure(lib)
            _init_poseidon(lib)
            _lib = lib
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sz = ctypes.c_size_t
    for name, args in {
        "fr_batch_inv": [u8p, sz],
        "g1_msm": [u8p, u8p, sz, u8p],
        "g1_fixed_base_muls": [u8p, u8p, sz, u8p],
        "keccak256": [u8p, sz, u8p],
        "keccak256_batch": [u8p, u64p, sz, u8p],
        "poseidon_init": [u8p, u8p],
        "poseidon_hash_batch": [u8p, sz, sz, u8p],
    }.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = None
    lib.poseidon_hash_batch.restype = ctypes.c_int
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mst_witness_fill.argtypes = [u8p, u8p, sz, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     i64p, sz, sz, sz, sz, i64p]
    lib.mst_witness_fill.restype = ctypes.c_int


def _init_poseidon(lib: ctypes.CDLL) -> None:
    from .ops import poseidon as PS

    rc = scalars_to_bytes([c for row in PS.ROUND_CONSTANTS for c in row])
    mds = scalars_to_bytes([c for row in PS.MDS for c in row])
    lib.poseidon_init(_u8(rc), _u8(mds))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# numpy-facing helpers (same byte formats as fieldcc.cpp)
# ---------------------------------------------------------------------------

def scalars_to_bytes(values) -> np.ndarray:
    """Canonical ints -> (n, 32) uint8 little-endian."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(values), 32).copy()


def bytes_to_scalars(arr: np.ndarray) -> list[int]:
    data = arr.tobytes()
    return [int.from_bytes(data[i * 32 : (i + 1) * 32], "little")
            for i in range(arr.shape[0])]


def points_to_bytes(points) -> np.ndarray:
    """[(x, y) | None] affine ints -> (n, 64) uint8; None = infinity (0, 0)."""
    chunks = [b"\x00" * 64 if p is None
              else p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")
              for p in points]
    return np.frombuffer(b"".join(chunks), dtype=np.uint8).reshape(len(points), 64).copy()


def _bytes_to_point(buf: np.ndarray):
    data = buf.tobytes()
    x = int.from_bytes(data[:32], "little")
    y = int.from_bytes(data[32:64], "little")
    return None if x == 0 and y == 0 else (x, y)


def g1_msm(points, scalars):
    """Host Pippenger over affine int points and canonical int scalars."""
    pts = points_to_bytes(points)
    scs = scalars_to_bytes(scalars)
    out = np.empty(64, dtype=np.uint8)
    get().g1_msm(_u8(pts), _u8(scs), len(points), _u8(out))
    return _bytes_to_point(out)


def g1_fixed_base_muls(base, scalars) -> list:
    """[s·base for s in scalars] (SRS generation)."""
    b = points_to_bytes([base])
    scs = scalars_to_bytes(scalars)
    out = np.empty((len(scalars), 64), dtype=np.uint8)
    get().g1_fixed_base_muls(_u8(b), _u8(scs), len(scalars), _u8(out))
    return [_bytes_to_point(out[i]) for i in range(len(scalars))]


def batch_inv(values) -> list[int]:
    """Fr batch inversion of canonical ints (zeros stay zero)."""
    buf = scalars_to_bytes(values)
    get().fr_batch_inv(_u8(buf), len(values))
    return bytes_to_scalars(buf)


def keccak256(data: bytes) -> bytes:
    inp = np.frombuffer(data, dtype=np.uint8).copy() if data else np.zeros(1, np.uint8)
    out = np.empty(32, dtype=np.uint8)
    get().keccak256(_u8(inp), len(data), _u8(out))
    return out.tobytes()


def poseidon_hash_bytes(msgs: np.ndarray, length: int) -> np.ndarray:
    """(n·L, 32) uint8 little-endian canonical scalars, L a message ->
    (n, 32) ConstantLength<L> Poseidon digests, on all host threads."""
    if msgs.dtype != np.uint8 or msgs.ndim != 2 or msgs.shape[1] != 32 or msgs.shape[0] % length:
        raise ValueError(f"poseidon_hash_bytes wants (n*{length}, 32) uint8, got "
                         f"{msgs.shape} {msgs.dtype}")
    msgs = np.ascontiguousarray(msgs)
    n = msgs.shape[0] // length
    out = np.empty((n, 32), dtype=np.uint8)
    if get().poseidon_hash_batch(_u8(msgs), n, length, _u8(out)) != 0:
        raise RuntimeError("poseidon_hash_batch: constants not initialised")
    return out


def poseidon_hash_batch(msgs, length: int) -> list[int]:
    """(n, L) canonical scalars -> n ConstantLength<L> Poseidon digests."""
    flat = [int(v) for row in msgs for v in row]
    return bytes_to_scalars(poseidon_hash_bytes(scalars_to_bytes(flat), length))


def mst_witness_fill(inputs: np.ndarray, blinds: np.ndarray, shape: tuple[int, int, int],
                     plan: np.ndarray, usable: int, out: np.ndarray) -> None:
    """The MstInclusion circuit's advice for U users, into ``out``, a
    (16, U, ncols, n) int64 array of Montgomery limbs (``csrc/fieldcc.cpp``).

    ``inputs``: (U * width, 32) uint8, each user's canonical inputs in the
    routine's order; ``blinds``: (U * ncols * (n - usable), 32) uint8, each
    user's blinding scalars column by column; ``shape``: (levels,
    n_currencies, n_bytes); ``plan``: int64 column * n + row of each cell
    the synthesis assigns, in its order, every row below ``usable``."""
    levels, ncur, nbytes = shape
    nlimbs, users, ncols, n = out.shape
    width = 1 + 2 * ncur + levels + 1 + (levels - 1) * (ncur + 2)
    if (nlimbs != 16 or out.dtype != np.int64 or not out.flags.c_contiguous
            or plan.dtype != np.int64 or not plan.flags.c_contiguous
            or inputs.shape != (users * width, 32) or inputs.dtype != np.uint8
            or blinds.shape != (users * ncols * (n - usable), 32) or blinds.dtype != np.uint8
            or not 0 < usable <= n):
        raise ValueError("mst_witness_fill: arrays do not match the shape")
    if plan.size and (plan.min() < 0 or plan.max() >= ncols * n or (plan % n >= usable).any()):
        raise ValueError("mst_witness_fill: the plan names a cell outside the usable rows")
    inputs, blinds = np.ascontiguousarray(inputs), np.ascontiguousarray(blinds)
    i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = get().mst_witness_fill(_u8(inputs), _u8(blinds), users, levels, ncur, nbytes,
                                i64(plan), plan.size, ncols, n, usable, i64(out))
    if rc == -2:
        raise ValueError("mst_witness_fill: the synthesis does not match the plan")
    if rc != 0:
        raise RuntimeError("mst_witness_fill: constants not initialised")
