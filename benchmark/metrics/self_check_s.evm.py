"""Seconds a proof in the port's self-check before calldata export: the
``self_check`` spans of ``utils/tracing`` (``models/verifier.verify_batch``:
the transcript replays, the fold and its pairing check) summed over the
traced window's calls, over the proofs."""


def read(t):
    if not t.counts.get("proofs") or not t.counts.get("self_check_ns"):
        return None
    return t.counts["self_check_ns"] / 1e9 / t.counts["proofs"]
