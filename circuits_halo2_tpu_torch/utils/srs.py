"""KZG structured reference string (SRS) — the halo2 ``ParamsKZG`` equivalent.

Raw file format (the reference's ``backend/ptau/hermez-raw-11`` layout):

    u32 k (LE)
    2^k  G1 points, monomial basis  [s^i]G      (64-byte raw affine, LE)
    2^k  G1 points, Lagrange basis  [L_i(s)]G   (64-byte raw affine, LE)
    G2 generator                                 (128-byte raw affine)
    [s]G2                                        (128-byte raw affine)

``setup(k, seed)`` is the unsafe deterministic testing setup, computed
through the port's native library, and ``setup_cached`` keeps it on disk in
the build directory.
"""

from __future__ import annotations

import hashlib
import os

from .. import build, native
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm
from ..ops import ntt as NTT
from . import ec_fft

DEFAULT_SEED = b"circuits-halo2-tpu-test-srs"


class ParamsKZG:
    """SRS with ``g`` (monomial) and ``g_lagrange`` G1 bases and the G2 pair."""

    def __init__(self, k: int, g, g_lagrange, g2, s_g2):
        self.k = k
        self.n = 1 << k
        self.g = g                    # monomial basis commitments [s^i]G1
        self.g_lagrange = g_lagrange  # Lagrange basis commitments
        self.g2 = g2
        self.s_g2 = s_g2

    @classmethod
    def read(cls, path: str) -> "ParamsKZG":
        with open(path, "rb") as f:
            data = f.read()
        k = int.from_bytes(data[:4], "little")
        n = 1 << k
        ofs = 4
        g = [C.g1_from_raw_bytes(data[ofs + 64 * i : ofs + 64 * (i + 1)]) for i in range(n)]
        ofs += 64 * n
        g_lagrange = [
            C.g1_from_raw_bytes(data[ofs + 64 * i : ofs + 64 * (i + 1)]) for i in range(n)
        ]
        ofs += 64 * n
        g2 = C.g2_from_raw_bytes(data[ofs : ofs + 128])
        s_g2 = C.g2_from_raw_bytes(data[ofs + 128 : ofs + 256])
        return cls(k, g, g_lagrange, g2, s_g2)

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.k.to_bytes(4, "little"))
            for p in self.g:
                f.write(C.g1_to_raw_bytes(p))
            for p in self.g_lagrange:
                f.write(C.g1_to_raw_bytes(p))
            f.write(C.g2_to_raw_bytes(self.g2))
            f.write(C.g2_to_raw_bytes(self.s_g2))

    @classmethod
    def setup(cls, k: int, seed: bytes = DEFAULT_SEED) -> "ParamsKZG":
        """UNSAFE deterministic test setup (same toxic waste and outputs as
        the JAX package's ``ParamsKZG.setup``); not for production."""
        n = 1 << k
        p = F.FR_MOD
        s = int.from_bytes(hashlib.sha256(seed + k.to_bytes(4, "little")).digest(), "little") % p
        powers = [1] * n
        for i in range(1, n):
            powers[i] = powers[i - 1] * s % p
        g = native.g1_fixed_base_muls(C.G1_GEN, powers)
        # L_i(s) = w^i (s^n - 1) / (n (s - w^i))
        omega = NTT.omega_for_k(k)
        scale = (F.fr_pow(s, n) - 1) * F.fr_inv(n) % p
        omega_pows = [1] * n
        for i in range(1, n):
            omega_pows[i] = omega_pows[i - 1] * omega % p
        denom_invs = native.batch_inv([(s - w) % p for w in omega_pows])
        g_lagrange = native.g1_fixed_base_muls(
            C.G1_GEN, [scale * w % p * di % p for w, di in zip(omega_pows, denom_invs)])
        return cls(k, g, g_lagrange, C.G2_GEN, C.g2_mul(C.G2_GEN, s))

    def downsize(self, k: int, device="cuda:0") -> "ParamsKZG":
        """Truncate to a smaller domain: the monomial bases truncate, and the
        Lagrange bases of the smaller domain are the inverse EC-FFT of the
        truncated monomial bases (``utils/ec_fft.g_to_lagrange`` on
        ``device``)."""
        if k == self.k:
            return self
        if k > self.k:
            raise ValueError("cannot upsize params")
        g = self.g[: 1 << k]
        return ParamsKZG(k, g, ec_fft.g_to_lagrange(g, k, device), self.g2, self.s_g2)

    def commit_lagrange(self, evals: list[int], device="cuda:0"):
        """Commit to a polynomial given by its evaluations on the 2^k domain."""
        if len(evals) != self.n:
            raise ValueError(f"commit_lagrange: {len(evals)} evaluations for n = {self.n}")
        return msm.msm_auto(self.g_lagrange, evals, device)

    def commit(self, coeffs: list[int], device="cuda:0"):
        """Commit to a polynomial in coefficient form (degree < 2^k)."""
        if len(coeffs) > self.n:
            raise ValueError(f"commit: {len(coeffs)} coefficients for n = {self.n}")
        return msm.msm_auto(self.g[: len(coeffs)], coeffs, device)


def cached_path(k: int):
    """Where ``setup_cached`` keeps ``ParamsKZG.setup(k)``."""
    return build.build_dir() / f"srs-unsafe-k{k}.bin"


def setup_cached(k: int) -> ParamsKZG:
    """``ParamsKZG.setup(k)``, read from the build directory when present."""
    path = cached_path(k)
    if path.exists():
        return ParamsKZG.read(str(path))
    params = ParamsKZG.setup(k)
    store_cached(params)
    return params


def store_cached(params: ParamsKZG) -> None:
    """Write ``params`` where ``setup_cached(params.k)`` reads it (atomically:
    concurrent writers race safely)."""
    path = cached_path(params.k)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    params.write(str(tmp))
    tmp.replace(path)
