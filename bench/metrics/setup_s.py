"""Seconds from the process's start to the window's: CUDA init, loading,
weights and data made from the seed, warm-up (and in a fresh checkout the
kernels' build)."""


def read(rec):
    return rec["setup_s"]
