"""KZG parameters: the JAX package's ``ParamsKZG`` (file I/O, attributes)
with an unsafe deterministic ``setup`` computed through the port's native
library, and an on-disk cache of it in the build directory.
"""

from __future__ import annotations

import hashlib
import os

from circuits_halo2_tpu.ops import curve as C
from circuits_halo2_tpu.ops import field as F
from circuits_halo2_tpu.utils import srs as _srs

from .. import build, native
from ..ops import ntt as NTT

DEFAULT_SEED = b"circuits-halo2-tpu-test-srs"


class ParamsKZG(_srs.ParamsKZG):
    """SRS with ``g`` (monomial) and ``g_lagrange`` G1 bases and the G2 pair."""

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

    def downsize(self, k: int) -> "ParamsKZG":
        if k == self.k:
            return self
        raise NotImplementedError("downsizing needs the EC-FFT, not ported yet")


def setup_cached(k: int) -> ParamsKZG:
    """``ParamsKZG.setup(k)``, read from the build directory when present."""
    path = build.build_dir() / f"srs-unsafe-k{k}.bin"
    if path.exists():
        return ParamsKZG.read(str(path))
    params = ParamsKZG.setup(k)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    params.write(str(tmp))
    tmp.replace(path)
    return params
