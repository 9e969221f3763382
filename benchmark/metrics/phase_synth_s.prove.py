"""Seconds a proof in the prover's phase 1 (witness synthesis and advice
commitments): the ``[prove] phase1 synth+advice commits`` lines of
``CIRCUITS_PROVE_TRACE`` summed over the window's calls, over the proofs."""

PHASE = "phase1 synth+advice commits"


def read(t):
    if not t.counts.get("proofs") or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.counts["proofs"]
