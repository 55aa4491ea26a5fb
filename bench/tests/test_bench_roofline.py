"""``pair_fuse_roofline.agg`` on synthetic records: the folds' bytes over
the trace's pair_fuse time, the same however many launches a fold
takes, and nothing where the trace and the kernel's counter disagree or
the trace holds no pair_fuse launch."""
import pytest

from fedbench import counts, registry

READ = registry.reader("pair_fuse_roofline.agg")
N = 167_567_808  # elements of an update
KERNEL = "void_pair_fuse_kernel<float, __nv_bfloat16>"


def record(kernels, units=1000, counted=999):
    return {"traffic": {"kind": "agg_backlog"}, "n_leaves": 17,
            "fold_bytes": counts.fold_bytes(N),
            "traced_step": {"units": units, "pair_fuse_launches": counted},
            "trace": {"kernels": {"elementwise_kernel": [4, 0.002],
                                  **kernels}}}


def expected(folds, seconds):
    return 100.0 * folds * counts.fold_bytes(N) / 3.35e12 / seconds


def test_one_launch_a_fold_reads_bytes_over_time():
    rec = record({KERNEL: [999, 0.5510]})
    assert READ(rec) == pytest.approx(expected(999, 0.5510), rel=1e-12)
    assert 90 < READ(rec) < 91  # 0.5002 ms at the bound, 0.5510 a fold


def test_two_launches_a_fold_read_the_same():
    one = READ(record({KERNEL: [999, 0.5510]}))
    two = READ(record({KERNEL: [999, 0.3], KERNEL + "_tail": [999, 0.2510]},
                      counted=1998))
    assert one == pytest.approx(expected(999, 0.5510), rel=1e-12)
    assert two == pytest.approx(one, rel=1e-12)


@pytest.mark.parametrize("counted", [998, 1000, 0])
def test_launches_other_than_the_counter_read_nothing(counted):
    assert READ(record({KERNEL: [999, 0.5510]}, counted=counted)) is None


def test_no_pair_fuse_in_the_trace_reads_nothing():
    assert READ(record({}, counted=0)) is None
    assert READ(record({}, counted=999)) is None


def test_an_untraced_run_or_a_single_update_reads_nothing():
    rec = record({KERNEL: [999, 0.5510]})
    assert READ(dict(rec, trace=None)) is None
    assert READ(record({KERNEL: [1, 0.001]}, units=1, counted=1)) is None
