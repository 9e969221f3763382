"""CUDA kernels in the traced window's profile over the proofs it made
(copies and sets not counted): the dispatch layer's launches a proof."""


def read(t):
    if not t.counts.get("proofs") or not t.kernels:
        return None
    return t.launches() / t.counts["proofs"]
