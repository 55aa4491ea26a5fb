"""The yardstick's byte formulas give the kernel table's bound."""
from fedbench import counts


def test_fold_bytes_give_the_kernel_tables_bound():
    # pair_fuse at N = 155,582,464: fp32 acc + bf16 update -> fp32, 0.4644 ms
    ms = 1e3 * counts.fold_bytes(155_582_464) / counts.PEAK_HBM_BYTES_S
    assert round(ms, 4) == 0.4644


def test_the_round_bound_is_below_the_streaming_folds():
    n, k = 1000, 1000
    streaming = (k - 1) * counts.fold_bytes(n)
    assert counts.round_min_bytes(n, k) < streaming
    assert counts.round_min_bytes(n, k) == n * (2 * k + 2)
