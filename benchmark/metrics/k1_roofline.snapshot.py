"""K1 (``csrc/poseidon.cu``, the batched Poseidon sponge) against its
roofline, %: the least time of the tree's permutations (``work.k1_work``:
49,568 wide multiplies each, L a message of L elements) over K1's device
time in the traced window's builds."""


def read(t):
    if not t.counts.get("builds"):
        return None
    return t.roofline("k1", "K1")
