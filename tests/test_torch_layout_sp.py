"""Sequence-parallel attention on a 2 x 2 layout: the four configs with
``sequence_parallel`` (reduced with it kept on), train and prefill at B 8
x 512 (two query chunks), the port's ``CollectiveRecord`` and the
reference's partitioned HLO computed here, against ``SP_STEPS``.

The residual stream's sequence is split over the model axis, and so are
K/V: the port keeps them split and distributes each query chunk's softmax
over the key blocks (``attention._split_key_attn``; the queries gathered
once a layer), as the reference's partitioner keeps K/V split and
all-reduces each chunk's attention output. So the two move comparable
bytes: the port at most 1.5 x the reference's TPU-adjusted total (before,
it gathered Q, K and V whole once a query chunk). Parameter gathers are
equal for qwen2.5-14b and
llama4-scout-17b-a16e; ``SP_DIFFER`` names the others.

Tolerance: none; counts and bytes are integers and agree exactly.
"""
import pytest

from _torch_layout import port_step, reference_step
from repro_torch.launch import layout

SP = {"sequence_parallel": True}
# (arch, kind): ((port parameter gathers: count, bytes), (the reference's),
# port counts by kind, the reference's), kinds in layout.KINDS order
SP_STEPS = {
    ("qwen2.5-14b", "train"): ((18, 1573888), (18, 1573888), (32, 31, 19, 0, 0), (33, 38, 0, 0, 0)),
    ("qwen2.5-14b", "prefill"): ((10, 918016), (10, 918016), (16, 6, 2, 2, 0), (18, 6, 0, 0, 0)),
    ("llama4-scout-17b-a16e", "train"): ((24, 4722688), (24, 4722688), (52, 31, 27, 3, 0), (47, 45, 0, 0, 0)),
    ("llama4-scout-17b-a16e", "prefill"): ((13, 2492416), (13, 2492416), (25, 10, 2, 3, 0), (24, 12, 0, 0, 0)),
    ("recurrentgemma-9b", "train"): ((72, 4874240), (54, 4460544), (110, 44, 48, 29, 0), (103, 61, 0, 56, 46)),
    ("recurrentgemma-9b", "prefill"): ((33, 2564096), (33, 2560000), (55, 6, 2, 12, 0), (55, 9, 0, 48, 52)),
    ("llama-3.2-vision-90b", "train"): ((72, 6684672), (68, 6553600), (140, 90, 73, 0, 0), (132, 138, 0, 0, 6)),
    ("llama-3.2-vision-90b", "prefill"): ((37, 3473408), (35, 3407872), (65, 24, 6, 8, 0), (66, 25, 0, 0, 2)),
}
# where the parameter all-gathers part, (port - reference) as (count,
# bytes), with the cause
SP_DIFFER = {
    # the RG-LRU's causal-conv taps (8 x (256,) f32): the reference's
    # TPU-adjusted column counts them at bf16 width, the port at their own
    ("recurrentgemma-9b", "prefill"): ((0, 8 * 512), "f32 conv taps"),
    # the backward's recompute gathers the layers' weights again in the
    # port, where XLA gathers fewer (which it reuses is not traced)
    ("recurrentgemma-9b", "train"): ((18, 413696), "backward's gathers"),
    ("llama-3.2-vision-90b", "train"): ((4, 131072), "backward's gathers"),
    # the cross-attention's wk / wv, (256, 1, 64) blocks: gathered by
    # both in the baseline layout (STEPS), by the port alone here
    ("llama-3.2-vision-90b", "prefill"): ((2, 2 * 32768),
                                         "cross-attention wk / wv"),
}


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", sorted({a for a, _ in SP_STEPS}))
def test_sequence_parallel_collectives_against_the_reference(arch, kind):
    port, ref, port_counts, ref_counts = SP_STEPS[(arch, kind)]
    record = port_step(arch, kind, seq=512, over=SP)
    (_, _, counts, total_tpu), ref_gathers = reference_step(
        arch, kind, seq=512, over=SP)
    assert record.param_gathers() == port
    assert ref_gathers == ref
    assert tuple(record.counts()[k] for k in layout.KINDS) == port_counts
    assert tuple(counts[k] for k in layout.KINDS) == ref_counts
    if (arch, kind) in SP_DIFFER:
        (dn, db), _ = SP_DIFFER[(arch, kind)]
        assert (port[0] - ref[0], port[1] - ref[1]) == (dn, db)
    else:
        assert port == ref
    assert record.total_bytes() <= 1.5 * total_tpu
