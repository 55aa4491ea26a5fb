"""Drive whole runs of each cell on the CPU at a small size (the look
for a card skipped) with the program's timed path broken underneath, and
see ``correct`` come out false for each fault the cell can have; the
same run unbroken is correct. The limits are the cells' own."""
import time

import pytest
import torch

from fedbench import registry, runner
from repro_torch.fl.aggregator import AggregationExecutor

SEED = 2**31 + 4242
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def _run(tiny, cell):
    config, traffic = tiny(cell)
    return runner.run(cell, SEED, 0.0, False, torch.device("cpu"),
                      time.perf_counter(), config=config, traffic=traffic)


def _state_unchanged(monkeypatch):
    """finish_round hands back the global model it was given."""
    real = AggregationExecutor.finish_round

    def finish(self, global_model, round_idx, lr=1.0):
        real(self, global_model, round_idx, lr)
        return global_model

    monkeypatch.setattr(AggregationExecutor, "finish_round", finish)


def _half_the_batch(monkeypatch):
    """drain folds every second update only (the mean over the rest) and
    reports them all."""
    def drain(self, round_idx, max_messages=1 << 30):
        topic = self.queue.topic(f"updates/{self.job_id}")
        n = 0
        for i, m in enumerate(topic.poll(self.group, max_messages)):
            if m.value["round"] == round_idx:
                if i % 2 == 0:
                    w = self.alg.weight_of(m.value.get("n_examples", 1))
                    self.state = self.state.fold(m.value["update"], w)
                n += 1
            topic.commit(self.group, m.offset)
        return n

    monkeypatch.setattr(AggregationExecutor, "drain", drain)


def _answer_altered(monkeypatch):
    """One element of the fused model changed where it is produced."""
    real = AggregationExecutor.finish_round

    def finish(self, global_model, round_idx, lr=1.0):
        out = real(self, global_model, round_idx, lr)
        leaf = out["embed"]
        leaf.view(-1)[0] += 1.0 + leaf.abs().max()
        return out

    monkeypatch.setattr(AggregationExecutor, "finish_round", finish)


@pytest.mark.parametrize("cell", CELLS)
def test_the_unbroken_run_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]


FAULTS = ["state_unchanged", "half_the_batch", "answer_altered"]


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS
                                         for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch)
    elif fault == "half_the_batch":
        _half_the_batch(monkeypatch)
    else:
        _answer_altered(monkeypatch)
    out = _run(tiny, cell)
    assert not out["correct"], out["checks"]
