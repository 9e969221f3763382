"""Poseidon round-number selection — security-margin calculator.

Parity target: `zk_prover/circuit_parameters_gen/calc_round_numbers.py`
(from the Poseidon reference scripts): find the minimal (R_F, R_P) for a
prime field of n bits, width t, s-box x^5, and security level M against the
known algebraic attack families (statistical, interpolation, Gröbner).
The reference's canonical instance (n=254, t=2, M=128) must yield
R_F=8, R_P=56 (`poseidon_params.rs` header).
"""

from __future__ import annotations

import math


def _security_ok(r_f: int, r_p: int, n: float, t: int, m: float) -> bool:
    """Check (R_F, R_P) against the attack bounds for alpha = 5."""
    r_f_stat = 6 if m <= (math.floor(2 * (m - math.log2(t)) / 3)) else 10
    # statistical attack bound (alpha = 5)
    if m <= (n - 2) * (t + 1) / 2:  # conservative applicability
        r_f_stat = 6
    else:
        r_f_stat = 10
    if r_f < r_f_stat:
        return False
    # interpolation attack
    r_itp = 0.43 * min(m, n) + math.log2(t)
    if r_f + r_p <= r_itp:
        return False
    # Gröbner basis attacks
    r_grb_1 = 0.21 * min(m, n)
    r_grb_2 = (0.14 * min(m, n) - 1 - math.log2(t)) / (t - 1) if t > 1 else 0
    if r_f + r_p <= r_grb_1:
        return False
    if r_f + r_p <= r_grb_2 + r_f:  # partial-round component bound
        return False
    return True


def find_round_numbers(
    n: int = 254, t: int = 2, m: int = 128, security_margin: bool = True
) -> tuple[int, int]:
    """Minimal-cost (R_F, R_P): scan R_F (even) and the smallest R_P passing
    the bounds; with the standard +2 full rounds / +7.5% partial margin."""
    best = None
    for r_f in range(4, 14, 2):
        for r_p in range(4, 200):
            if _security_ok(r_f, r_p, n, t, m):
                cost = (r_f * t + r_p)  # s-box count
                if best is None or cost < best[2]:
                    best = (r_f, r_p, cost)
                break
    assert best is not None
    r_f, r_p, _ = best
    if security_margin:
        r_f += 2
        r_p = int(math.ceil(r_p * 1.075))
        # round partial rounds up to even (the Pow5 layout packs 2 per row)
        r_p += r_p % 2
    return r_f, r_p
