"""The optimized profile's expert-parallel MoE branch on a 2 x 2 layout:
reduced qwen2-moe-a2.7b's train, prefill and decode steps at B 8 x 64, the
port's ``CollectiveRecord`` and the reference's partitioned HLO computed
here, against ``OPT_STEPS`` (``tests/_torch_layout.py``). The branch takes
each rank's experts only, as the reference's ``shard_map`` does
(``in_specs`` P(model, None, None)), so no rank gathers every expert. In
prefill the three expert weights reach the branch by an all-to-all and
then an all-gather of its output (``OPT_DIFFER``), their bytes those of
the reference's three parameter gathers.

Tolerance: none; counts and bytes are integers and agree exactly.
"""
import pytest

from _torch_layout import OPT_DIFFER, check_step


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_optimized_moe_collectives_against_the_reference(kind):
    record = check_step("qwen2-moe-a2.7b", kind, "optimized")
    # no rank gathers every expert: a gather of expert weights (4 experts,
    # d 256, d_ff 512, bf16) stacks the data axis's two blocks of the
    # rank's 2 experts, half of the whole layer's weight
    whole = 4 * 256 * 512 * 2
    experts = [c for c in record.items if c.kind == "all-gather"
               and c.site.startswith("models/moe.py") and len(c.shape) == 3]
    assert all(c.nbytes == whole // 2 for c in experts)
    if kind == "prefill":
        (dn, db), _ = OPT_DIFFER[("qwen2-moe-a2.7b", kind)]
        assert len(experts) == -dn and sum(c.nbytes for c in experts) == -db
