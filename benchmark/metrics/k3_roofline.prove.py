"""K3 (``csrc/msm_scan.cu``, the MSM's bucket scan) against its roofline, %:
the least time of the work its calls' arguments need (``work.k3_work``:
bytes read and written once, mixed adds of the points that continue a
segment) over K3's device time in the traced window."""


def read(t):
    if not t.counts.get("proofs"):
        return None
    return t.roofline("k3", "K3")
