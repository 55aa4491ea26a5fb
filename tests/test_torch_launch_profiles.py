"""The launchers' sharding flags on the CPU.

``serve.main`` accepts ``--profile optimized`` and ``--force-host`` as the
reference's does, and generates the same tokens with them as without:
the reference's server never reads either on its serve path.

``train.main --profile optimized`` builds a 1 x 1 mesh in a one-rank gloo
group it starts and destroys itself (no group is left behind in this
process), installs the optimized profile's activation rules, and so runs
the MoE layers through the expert-parallel branch, whose calls a spy
counts. On one rank that branch computes what the baseline's computes,
in the same order, so the losses are equal, ``==``, for the MoE config
and for a dense one (where the optimized profile's ``constrain`` calls
are identities on plain tensors).
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import serve, steps, train
from repro_torch.models import moe

torch.set_num_threads(1)
REAL_STEP, REAL_BRANCH = steps.make_train_step, moe._moe_apply_shard_map
REAL_GENERATE = serve.generate


def _tokens(monkeypatch, argv):
    got = []

    def spy(*a, **kw):
        out = REAL_GENERATE(*a, **kw)
        got.append(out.tokens.clone())
        return out

    monkeypatch.setattr(serve, "generate", spy)
    assert serve.main(argv) == 0
    (tokens,) = got
    return tokens


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_serve_flags_change_no_token(monkeypatch, arch):
    base = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
            "--tokens", "5", "--device", "cpu"]
    want = _tokens(monkeypatch, base)
    assert want.shape == (2, 5)
    for extra in (["--profile", "optimized"], ["--force-host"],
                  ["--profile", "optimized", "--force-host"]):
        assert torch.equal(_tokens(monkeypatch, base + extra), want)
    assert not dist.is_initialized()


def _losses(monkeypatch, argv):
    """train.main's loss at each step, full precision, and the calls of
    the expert-parallel branch."""
    losses, calls = [], []

    def make_step(cfg, optimizer=None):
        step = REAL_STEP(cfg, optimizer)

        def recorded(params, opt_state, batch):
            out = step(params, opt_state, batch)
            losses.append(float(out[2]["loss"]))
            return out

        return recorded

    def branch(cfg, p, x, mesh, batch_axes, model_axis):
        calls.append((tuple(mesh.shape), batch_axes, model_axis))
        return REAL_BRANCH(cfg, p, x, mesh, batch_axes, model_axis)

    monkeypatch.setattr(steps, "make_train_step", make_step)
    monkeypatch.setattr(moe, "_moe_apply_shard_map", branch)
    assert train.main(argv) == 0
    return losses, calls


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-0.6b"])
def test_train_optimized_profile_matches_baseline(monkeypatch, arch):
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
            "--seq-len", "16", "--device", "cpu"]
    base, base_calls = _losses(monkeypatch, argv)
    opt, opt_calls = _losses(monkeypatch, argv + ["--profile", "optimized"])
    assert not dist.is_initialized()  # the launcher's group is gone
    assert len(base) == 3 and opt == base
    assert base_calls == []
    if arch == "qwen2-moe-a2.7b":
        # one MoE layer a forward, recomputed once in the backward (remat),
        # for each of the 3 steps
        assert opt_calls and set(opt_calls) == {((1, 1), ("data",), "model")}
        assert len(opt_calls) % 3 == 0
    else:
        assert opt_calls == []


def test_train_mesh_options_name_the_next_slice(capsys):
    """``--shape`` and ``--force-host``, which raised until the production
    layout was ported, now run: ``--shape`` on the production mesh of the current group (none
    here: it raises naming the 256 ranks), ``--force-host`` dry steps on a
    256-rank layout-only group it starts and destroys, printing each
    step's collectives and no loss."""
    with pytest.raises(RuntimeError, match="256 ranks"):
        train.main(["--arch", "qwen2-moe-a2.7b", "--shape", "train_4k",
                    "--device", "cpu", "--profile", "optimized"])
    assert not dist.is_initialized()
    assert train.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                       "--force-host", "--steps", "1", "--batch", "16",
                       "--seq-len", "8", "--profile", "optimized"]) == 0
    out = capsys.readouterr().out
    assert "step 0: collectives {" in out and "loss=" not in out
    assert not dist.is_initialized()
