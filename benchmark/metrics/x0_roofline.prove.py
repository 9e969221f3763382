"""X0a and X0b (``csrc/field_ops.cu``: Montgomery products, and add, sub,
neg) against their roofline, %: the least time of the work their calls'
operands need (``work.x0_work``: 132 wide multiplies a product, limbs read
and written once) over X0a's and X0b's device time in the traced window."""


def read(t):
    if not t.counts.get("proofs"):
        return None
    return t.roofline("x0", "X0a", "X0b")
