"""Peak device memory over the traced window's calls, GB (10^9 bytes):
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start."""


def read(t):
    if not t.counts.get("proofs"):
        return None
    return t.peak_bytes / 1e9
