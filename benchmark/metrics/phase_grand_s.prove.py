"""Seconds a proof in the prover's phase 3 (grand products and their
commitments): the ``[prove] phase3 grand products+commits`` lines summed
over the window's calls, over the proofs."""

PHASE = "phase3 grand products+commits"


def read(t):
    if not t.counts.get("proofs") or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.counts["proofs"]
