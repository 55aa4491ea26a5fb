"""Run an aggregator cell with the program's own spans on, and print what
they read beside the device trace of one round.

    python bench/spans_run.py --workload <cell> --seed <n> --seconds <s> [--spans 0|1]

from the root of a checkout, on the card. After the cell's set-up the
queue and the executor are built anew, with a wall-clock tracer
(``--spans 1``) or with the program's default (``--spans 0``: the same
run, spans off), and warmed up again. Then whole rounds run back to back
for ``--seconds``, each drain closed by a synchronise as in a traced run
of ``run.py`` (``fold_ms``: ``fold_ms.agg``'s reading), and one more
round runs under the device trace. Standard error ends with the traced
round's idle seconds by the innermost program span covering each gap's
start, then covering each idle nanosecond (the round's first gap opens
with the trace, outside every span, and runs on through the publish
loop), and how many of ``pair_fuse``'s launch calls start inside an
``agg.fold`` span; the last line of standard output is one JSON object
(``fedbench/spans.py`` says what each reading is). Nothing here is a
metric of ``BENCHMARK.json``; ``run.py`` reads none of it.
"""
import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import run  # noqa: F401  the checkout's build directories and import paths

import torch  # noqa: E402

from fedbench import devtrace, layout, registry, spans  # noqa: E402
from fedbench.kinds import agg_backlog  # noqa: E402


#: each round's first folds that launch: a round opens on an empty launch
#: queue, so these show the host's own cost while the queue fills
FIRST_FOLDS = 20


def median(xs: list) -> Optional[float]:
    return statistics.median(xs) if xs else None


def log(msg: str) -> None:
    print(f"spans: {msg}", file=sys.stderr, flush=True)


class SpannedTraffic(agg_backlog.Traffic):
    """The cell's traffic, its queue and executor built anew after set-up
    with a wall-clock tracer (``spans``) or without, and warmed up again."""

    def __init__(self, *args, spans: bool):
        super().__init__(*args)
        self.spans = spans
        self.tracer = None

    def setup(self) -> None:
        from repro_torch.core.queue import MessageQueue
        from repro_torch.fl.aggregator import AggregationExecutor
        from repro_torch.obs.trace import Tracer

        super().setup()
        kw = {}
        if self.spans:
            self.tracer = Tracer(clock="wall")
            kw = {"tracer": self.tracer}
        self.queue = MessageQueue(**kw)
        self.agg = AggregationExecutor(self.job, self.traffic["algorithm"],
                                       self.queue, **kw)
        for _ in range(self.traffic["warmup_rounds"]):
            self.step()
        self.take()

    def take(self) -> list:
        """The spans of the rounds since the last call."""
        return self.tracer.take_spans() if self.tracer else []


def card() -> str:
    """The card's name and power limit."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run_cell(cell_name: str, seed: int, seconds: float, with_spans: bool,
             device: torch.device, config: Optional[Dict] = None,
             traffic: Optional[Dict] = None) -> Dict:
    """The readings of one run; ``config`` / ``traffic`` replace the
    cell's files (small sizes on the CPU in the tests)."""
    cell = registry.cell(cell_name)
    config = layout.with_leaves(config or registry.config(cell["config"]))
    traffic = traffic or registry.traffic(cell_name)
    drv = SpannedTraffic(cell, config, traffic, seed, device,
                         spans=with_spans)
    drv.setup()
    drv.trace_spans = True  # a synchronise closes each drain
    steps, rounds = [], []
    t0 = time.perf_counter()
    while True:
        steps.append(drv.step())
        rounds.append(drv.take())
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    gaps = launches = summary = None
    if device.type == "cuda":
        with spans.RoundTrace(device) as tr:
            drv.step()
        gaps, launches, summary = tr.gaps, tr.launches, tr.summary
    else:
        drv.step()
    traced = drv.take()

    parts = spans.queue_parts_ms(rounds)
    out = {
        "cell": cell_name, "seed": seed, "spans": with_spans,
        "rounds": len(steps), "window_s": window_s,
        "updates_per_s": sum(s["units"] for s in steps) / window_s,
        "fold_ms": 1e3 * sum(s["drain_s"] for s in steps)
        / sum(s["units"] for s in steps),
        "fold_host_us": spans.fold_host_us(rounds),
        "fold_host_us_first": spans.fold_host_us(rounds, FIRST_FOLDS),
        "queue_ms": spans.queue_ms(rounds),
        "queue_publish_ms": median([p for p, _ in parts]),
        "queue_drain_ms": median([d for _, d in parts]),
        "finish_ms": spans.finish_ms(rounds),
        "finish_host_ms": spans.span_ms(rounds, spans.FINISH),
        "device_allocs": spans.device_allocs(rounds),
        "idle_in_fold_ms": spans.idle_in_fold_ms(gaps, traced),
    }
    if summary is not None:
        iv = spans.intervals(traced)
        by_start = spans.idle_by_span(gaps, iv)
        pieces = collections.defaultdict(list)
        for g0, g1, name in spans.innermost(spans.cut(gaps, iv), iv):
            pieces[name].append((g0, g1))
        out.update(
            busy_s=summary["busy_s"], trace_window_s=summary["window_s"],
            idle_by_span=by_start,
            idle_by_span_split=spans.idle_by_span(gaps, iv, split=True),
            # each span's idle pieces by the host operation over their start
            idle_by_span_op={k: devtrace._name_gaps(v, tr.host)
                             for k, v in pieces.items()},
            idle_gaps=devtrace.breakdown(summary)["idle_gaps"],
            launches_in_fold=[spans.inside(launches, traced, spans.FOLD),
                              len(launches)])
        for how, idle in (("gap starts", by_start),
                          ("idle ns", out["idle_by_span_split"])):
            log(f"idle by span ({how}): " + ", ".join(
                f"{k} {v:.6f} s" for k, v in sorted(idle.items(),
                                                      key=lambda kv: -kv[1]))
                + f" (of {sum(idle.values()):.6f} s idle in "
                f"{summary['window_s']:.6f} s)")
        log(f"pair_fuse launch calls inside agg.fold: "
            f"{out['launches_in_fold'][0]} of {len(launches)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this runs on the card only", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.spans),
                   torch.device("cuda", 0))
    out["device"] = card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
