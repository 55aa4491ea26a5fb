"""The port's one-card dry run (``repro_torch.launch.dryrun``) on the CPU:
every step built on "meta" tensors and run once under ``FlopCounterMode``.

``run_one`` on reduced configs, one per block family, at the four
``INPUT_SHAPES``: the JSON keeps the reference's keys, and the FLOPs it
counts equal, exactly, the analytic count with the port's known
differences written out (``expected_counted``):

  * attention scores over the full square: each chunk of queries scores
    every key (the analytic count takes the causal mean context), and a
    decode step scores every slot of its cache (the analytic count caps a
    ``swa`` decode at ``swa_window``; ``test_torch_roofline.py``);
  * MoE experts run over capacity slots, ``moe.capacity`` of the tokens
    (the analytic count takes tokens x k x capacity_factor);
  * a VLM decode reads its image K/V from the cache (no projection);
  * the counter sees matrix products only: not the convolutions (taps
    summed elementwise), the RG-LRU scan, or the SSD decode's state update
    (a broadcast product);
  * training is forward + backward (3 x), less one product for the image
    K/V projection (no gradient for the image embeddings), plus the
    rematerialised forward of each super-block but its last product (the
    checkpoint's recomputation stops once every saved tensor is back; a
    MoE block recomputes whole, its aux loss coming last). The analytic
    count remats the LM head as well and every block whole.

Tolerance: none; the counts are integers and agree exactly.
"""
import json

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun, roofline_report, steps
from repro_torch.launch.mesh import H100
from repro_torch.launch.roofline import analytic_roofline
from repro_torch.models import model as M
from repro_torch.models import moe

configs.load_all()


@pytest.fixture
def reduced(monkeypatch):
    """Every architecture's ``reduced()`` config at the same shapes."""
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda a: full(a).reduced())


@pytest.fixture
def results(tmp_path, monkeypatch):
    """The dry run's results directory, for this test alone."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    monkeypatch.setattr(roofline_report, "RESULTS", tmp_path)
    return tmp_path


# one config per block family: attention, MoE, SSD, RG-LRU hybrid with a
# windowed attention, cross-attention, audio codebooks
FAMILIES = ("qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-130m",
            "recurrentgemma-9b", "llama-3.2-vision-90b", "musicgen-large")
KEYS = ("arch", "shape", "chips", "kind", "ok", "profile", "params",
        "active_params", "flops_global", "hbm_bytes_global",
        "compute_term_s", "memory_term_s", "collective_term_s", "dominant",
        "model_flops_global", "useful_flops_ratio")


def _block_fwd(cfg, bt, t, b, s, kind, cap):
    """Matrix-product FLOPs of one block's forward, as the port runs it."""
    d = cfg.d_model
    mlp = 2 * t * 3 * d * cfg.d_ff
    if bt in ("attn", "lattn", "moe"):
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        f = 2 * t * d * (2 * h * hd + 2 * kv * hd)
        ctx = s
        if kind == "decode":
            ctx = min(cap, cfg.sliding_window or cap) if bt == "lattn" else cap
        f += 4 * t * ctx * h * hd
        if bt != "moe":
            return f + mlp
        e = cfg.num_experts
        c = moe.capacity(cfg, 1 if kind == "decode" else s)
        return (f + 2 * t * d * e + 2 * b * e * c * 3 * d * cfg.d_ff
                + 2 * t * 3 * d * cfg.d_ff * cfg.num_shared_experts)
    if bt == "xattn":
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        p = cfg.num_image_tokens
        f = 2 * t * d * 2 * h * hd + 4 * t * p * h * hd + mlp
        return f + (0 if kind == "decode" else _image_kv(cfg, b))
    if bt == "rglru":
        r = cfg.rnn_width
        return 2 * t * d * r * 3 + 2 * t * r * r * 2 + mlp
    if bt == "ssm":
        din, n = cfg.d_inner, cfg.ssm_state
        hh, pd = cfg.ssm_heads, cfg.ssm_head_dim
        f = 2 * t * d * (2 * din + 2 * n + hh) + 2 * t * din * d
        if kind == "decode":
            return f + 2 * t * hh * pd * n  # the readout only
        q = min(cfg.ssm_chunk, s)
        return f + 2 * t * q * n + 2 * t * q * hh * pd + 4 * t * n * hh * pd
    raise ValueError(bt)


def _image_kv(cfg, b):
    return 2 * b * cfg.num_image_tokens * cfg.d_model * 2 \
        * cfg.num_kv_heads * cfg.head_dim


def _last_product(cfg, bt, t):
    """The super-block's last product, which its recomputation skips."""
    if bt == "moe":
        return 0
    if bt == "ssm":
        return 2 * t * cfg.d_inner * cfg.d_model
    return 2 * t * cfg.d_ff * cfg.d_model  # the MLP's down projection


def expected_counted(cfg, shape) -> int:
    kind, b, s = shape.kind, shape.global_batch, shape.seq_len
    t = b * (1 if kind == "decode" else s)
    cap = steps.decode_capacity(cfg, shape) if kind == "decode" else s
    head = 2 * t * cfg.d_model * cfg.vocab_size * (cfg.num_codebooks or 1)
    blocks = sum(_block_fwd(cfg, bt, t, b, s, kind, cap)
                 for bt in cfg.block_types())
    if kind != "train":
        return head + blocks
    image = sum(_image_kv(cfg, b) for bt in cfg.block_types()
                if bt == "xattn")
    remat = sum(
        reps * (sum(_block_fwd(cfg, bt, t, b, s, kind, cap) for bt in pat)
                - _last_product(cfg, pat[-1], t))
        for pat, reps in cfg.stages())
    return 3 * (head + blocks) - image + remat


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_one_keys_and_counted_flops(arch, shape_name, reduced):
    out = dryrun.run_one(arch, shape_name, verbose=False)
    cfg = configs.get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    assert all(k in out for k in KEYS)
    assert (out["mesh"], out["chips"], out["ok"], out["kind"]) == (
        "h100x1", 1, True, shape.kind)
    rl = analytic_roofline(cfg, shape, 1, 0.0, H100)
    assert out["flops_global"] == rl.flops
    assert out["memory_term_s"] == rl.memory_s
    assert out["collective_term_s"] == 0.0
    assert out["collective_bytes_per_device"] == 0
    assert not any(out["collective_by_kind"].values())
    assert out["params"] == M.n_params(cfg)
    assert out["counted_flops"] == expected_counted(cfg, shape)
    assert out["counted_flops"] == sum(out["counted_flops_by_op"].values())
    mem = out["memory_analysis"]
    assert mem["temp_bytes"] is None
    assert mem["argument_bytes"] == sum(mem["argument_bytes_by_part"].values())
    assert mem["argument_bytes_by_part"]["params"] == M.n_params(cfg) * 2
    if shape.kind == "train":  # fp32 AdamW moments
        assert mem["argument_bytes_by_part"]["opt_state"] == \
            M.n_params(cfg) * 8 + 4
    assert out["fits_one_card"] == (mem["argument_bytes"] <= 80e9)
    json.dumps(out)


def test_counted_on_real_tensors_equals_meta():
    """The count depends on shapes only: a real train step of reduced
    qwen3-0.6b on the CPU counts what its meta twin counts (``chip_smoke.py``
    checks the same on the card at full width)."""
    cfg = configs.get_config("qwen3-0.6b").reduced()
    shape = InputShape("small", 64, 2, "train")
    fn, meta_args, _ = steps.build(cfg, shape)
    from repro_torch.optim import adamw

    params = M.init(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    real = (params, adamw(3e-4).init(params),
            {"tokens": tok, "labels": torch.roll(tok, -1, 1)})
    assert (dryrun.counted_flops(fn, *real)[1:]
            == dryrun.counted_flops(fn, *meta_args)[1:])


def test_all_reduced_writes_forty_results(reduced, results, capsys):
    assert dryrun.main(["--all"]) == 0
    files = sorted(results.glob("*.json"))
    assert len(files) == 40
    rows = [json.loads(f.read_text()) for f in files]
    assert all(r["ok"] and r["mesh"] == "h100x1" for r in rows)
    # the report reads them
    roofline_report.main([])
    text = capsys.readouterr().out
    assert "H100 terms" in text and text.count("| qwen3-0.6b |") == 8


def test_failed_combination_is_recorded_and_exits_nonzero(reduced, results,
                                                          monkeypatch):
    real = dryrun.run_one

    def flaky(arch, shape, **kw):
        if (arch, shape) == ("mamba2-130m", "decode_32k"):
            raise RuntimeError("boom")
        return real(arch, shape, **kw)

    monkeypatch.setattr(dryrun, "run_one", flaky)
    monkeypatch.setattr(dryrun, "_combo_list", lambda: [
        ("mamba2-130m", "decode_32k"), ("mamba2-130m", "long_500k")])
    assert dryrun.main(["--all"]) == 1
    bad = json.loads((results / "mamba2-130m__decode_32k__h100x1.json"
                      ).read_text())
    assert bad["ok"] is False and "boom" in bad["error"]
    good = json.loads((results / "mamba2-130m__long_500k__h100x1.json"
                       ).read_text())
    assert good["ok"] is True
    assert roofline_report.fmt_row(bad).endswith("FAILED | | | | | | |")


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--profile", "optimized"],
    ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--multi-pod"],
])
def test_mesh_options_raise(argv):
    with pytest.raises(NotImplementedError):
        dryrun.main(argv)


def test_single_run_writes_json(tmp_path, reduced):
    path = tmp_path / "one.json"
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                        "--json", str(path)]) == 0
    out = json.loads(path.read_text())
    assert out["arch"] == "mamba2-130m" and out["config"].endswith("reduced")


def test_full_size_qwen3_train_count():
    """qwen3-0.6b x train_4k at full size on meta tensors: the count is
    the port's formula, 1.2093 x the analytic count (full-square scores,
    the remat that skips the LM head and each layer's down projection)."""
    cfg = configs.get_config("qwen3-0.6b")
    shape = INPUT_SHAPES["train_4k"]
    fn, args, _ = steps.build(cfg, shape)
    counted = dryrun.counted_flops(fn, *args)[1]
    assert counted == expected_counted(cfg, shape)
    assert round(counted / analytic_roofline(cfg, shape, 1, 0.0).flops,
                 4) == 1.2093


def test_run_one_prints_its_numbers(capsys):
    out = dryrun.run_one("mamba2-130m", "long_500k")
    text = capsys.readouterr().out
    assert "== mamba2-130m x long_500k x h100x1 ==" in text
    assert f"flops={out['counted_flops']:.4e}" in text
    assert out["params"] == M.n_params(configs.get_config("mamba2-130m"))
