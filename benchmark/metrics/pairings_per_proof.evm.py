"""Pairing checks a proof in the traced window: the port's ``verify`` /
``pairings`` count over the proofs made (one folded check a call of U
users reads 1/U; a check a proof reads 1)."""


def read(t):
    if not t.counts.get("proofs") or not t.counts.get("verify_proofs"):
        return None
    return t.counts.get("verify_pairings", 0) / t.counts["proofs"]
