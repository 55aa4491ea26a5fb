"""End-to-end FL job runtime: REAL local training at the parties, real
kernel-based fusion at the aggregator, and a scheduling timeline evaluated
on a virtual clock driven by the measured training times.

Each round's measured per-party arrivals (real train time + t_comm) are
pushed into a ``MeasuredArrivals`` source and replayed through the shared
``RoundEngine`` under any registered strategy policy. The default policy is
the deterministic JIT timeline (``jit_policy="fixed"``: deploy exactly at
t_rnd − t_agg, stay hot to completion, calibrate the estimator online).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import Pytree, get_device, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import Cluster, ClusterConfig
from repro_torch.core.estimator import AggregationEstimator
from repro_torch.core.events import Simulator
from repro_torch.core.jobspec import FLJobSpec
from repro_torch.core.metrics import JobMetrics
from repro_torch.core.policy import PolicyConfig, as_replay_policy
from repro_torch.core.queue import MessageQueue
from repro_torch.core.strategies import MeasuredArrivals, RoundEngine
from repro_torch.data.partition import dirichlet_domain_mixes, party_sizes
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.fl.aggregator import AggregationExecutor
from repro_torch.fl.party import Party
from repro_torch.kernels.ops import accumulate
from repro_torch.models import model as M

CPU_PROBE_CAP = 4 << 20  # bytes; the CPU probes a slice and scales up


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    arrivals: Dict[str, float]  # virtual arrival offsets (train + comm)
    t_rnd_pred: float
    t_agg_pred: float
    trigger: float  # first-deploy offset (planned trigger under fixed JIT)
    completion: float  # offset of the round's last fused update + checkpoint
    latency: float  # §6.2: completion − last arrival
    container_seconds: float  # billed this round (eager-AO bills at job end)
    global_loss: float


def probe_t_pair(leaf_sizes: Sequence[int], update_dtype: torch.dtype,
                 device: torch.device, trials: int = 7) -> float:
    """Offline t_pair measurement (§5.4): median time of one fold of an
    update in ``update_dtype``, with leaves of ``leaf_sizes`` elements, into
    an fp32 accumulator of the same leaves, already on ``device``, after
    3 untimed folds, with the device synchronised inside each timed
    call. The fold is the streaming one, the paper's t_pair
    (``kernels.ops.accumulate``: one
    ``pair_fuse`` wsum launch a fold, over a table of every leaf, so that a
    small model's fold is bound by the card and not by the shared host's
    speed, which drifts between this probe and the folds it predicts;
    PERF.md section 6), and the runtime passes the global model's leaf
    sizes and dtype, so the probe pays what a real fold pays for its
    leaves (the small ones' blocks at the grid's tail) as well as for each
    byte. A drain folds a backlog up to eight updates a launch
    (``kernels.batch_fold``) and spends less an update than this; the
    probe does not model that. On the card the probe is the full model; the
    CPU probes at most ``CPU_PROBE_CAP`` bytes of accumulator, every leaf
    cut by the same factor, and scales the time by the elements left out
    (fusion is linear in bytes)."""
    total = max(sum(leaf_sizes), 1)
    cap = total if device.type == "cuda" else CPU_PROBE_CAP // 4
    sizes = [max(1, n * min(cap, total) // total) for n in leaf_sizes]
    gen = torch.Generator(device=device).manual_seed(0)
    acc = [torch.randn(n, generator=gen, device=device) for n in sizes]
    upd = [torch.randn(n, generator=gen, device=device).to(update_dtype)
           for n in sizes]

    def timed() -> float:
        t0 = time.perf_counter()
        accumulate(acc, upd, 1.0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    for _ in range(3):  # warmup
        timed()
    t_pair = statistics.median(timed() for _ in range(max(trials, 3)))
    return t_pair * total / sum(sizes)


class FLJobRuntime:
    def __init__(
        self,
        cfg: ModelConfig,
        spec: FLJobSpec,
        *,
        policy: Union[PolicyConfig, str, None] = None,
        n_sequences: int = 256,
        heterogeneous: bool = False,
        eval_sequences: int = 64,
        seed: int = 0,
        epochs_per_round: int = 1,
        device: Union[str, torch.device, None] = None,
        initial_params: Optional[Pytree] = None,
        cluster_config: Optional[ClusterConfig] = None,
        estimator: Optional[AggregationEstimator] = None,
    ):
        """``initial_params``: the global model to start from (a tree of
        tensors, e.g. the reference's weights through ``interop.to_torch``);
        by default it is drawn from a ``torch.Generator`` seeded ``seed``.

        A config with image tokens (the xattn family) is refused: the
        parties' synthetic data holds text tokens only, and its
        cross-attention blocks read ``image_embeds``. The reference fails
        there too, at its first local step."""
        if cfg.num_image_tokens:
            raise ValueError(
                f"{cfg.name}: federated training of a config with image "
                f"tokens is not supported: the parties' batches carry no "
                f"image_embeds for its cross-attention blocks")
        self.cfg = cfg
        self.spec = spec
        self.device = get_device(device)
        self.epochs = epochs_per_round
        self.policy = as_replay_policy(policy)
        self.queue = MessageQueue()
        self.agg = AggregationExecutor(
            spec.job_id, spec.aggregation_algorithm, self.queue)
        # ---- data ---------------------------------------------------------
        data_cfg = SyntheticLMConfig(
            vocab_size=cfg.vocab_size,
            seq_len=64,
            n_codebooks=cfg.num_codebooks,
        )
        self.lm = SyntheticLM(data_cfg, seed=seed)
        n_parties = spec.n_parties
        mixes = dirichlet_domain_mixes(n_parties, data_cfg.n_domains, seed=seed)
        sizes = party_sizes(n_parties, n_sequences, heterogeneous, seed=seed)
        self.parties: Dict[str, Party] = {}
        for i, (pid, pspec) in enumerate(spec.parties.items()):
            ds = self.lm.make_dataset(mixes[i], sizes[i], seed=seed + 1 + i)
            self.parties[pid] = Party(
                pid, cfg, ds,
                algorithm=spec.aggregation_algorithm,
                batch_size=spec.batch_size, lr=spec.lr,
                prox_mu=spec.prox_mu, seed=seed + i, device=self.device,
            )
            pspec.dataset_size = sizes[i]
            pspec.batch_size = spec.batch_size
        # ---- §5.2: parties measure + report their minibatch/epoch times -----
        if initial_params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.global_params = M.init(cfg, gen)
        else:
            self.global_params = tree_map(lambda t: t.to(self.device),
                                          initial_params)
        for pid, party in self.parties.items():
            t_mb, t_ep = party.calibrate(self.global_params)
            spec.parties[pid].minibatch_time_s = t_mb
            spec.parties[pid].epoch_time_s = t_ep
        # held-out eval data (uniform domain mix)
        self.eval_data = self.lm.make_dataset(
            np.full(data_cfg.n_domains, 1.0 / data_cfg.n_domains),
            eval_sequences, seed=seed + 10_000,
        )
        # ---- scheduling machinery -------------------------------------------
        if estimator is None:  # every leaf has the config's dtype
            leaves = tree_leaves(self.global_params)
            estimator = AggregationEstimator(probe_t_pair(
                [t.numel() for t in leaves], leaves[0].dtype, self.device))
        self.estimator = estimator
        self.t_pair0 = self.estimator.t_pair_s  # pre-calibration t_pair
        self.cluster_cfg = cluster_config or ClusterConfig()
        # virtual replay: a RoundEngine on a private simulated cluster, fed
        # this job's measured arrivals one (gated) round at a time, so the
        # engine's predictor/estimator state evolves exactly in step with
        # the real rounds
        self.sim = Simulator()
        self.cluster = Cluster(self.sim, self.cluster_cfg)
        self.source = MeasuredArrivals()
        self._round_done_t: Dict[int, float] = {}
        self.engine = RoundEngine(
            self.sim, self.cluster, spec, self.estimator, self.policy,
            arrival_model=self.source,
            gated_rounds=True,
            single_worker_fuse=True,
            on_round_complete=self._round_done_t.__setitem__,
        )
        self.predictor = self.engine.predictor  # shared with the replay
        self.records: List[RoundRecord] = []
        self.measured_rounds: List[Dict[str, Tuple[float, float]]] = []

    # ------------------------------------------------------------------------
    @torch.no_grad()
    def eval_loss(self) -> float:
        batch = {k: torch.from_numpy(np.asarray(v, np.int64)).to(self.device)
                 for k, v in self.eval_data.items() if k != "domains"}
        return float(M.loss_fn(self.cfg, self.global_params, batch)[0])

    def run_round(self, round_idx: int) -> RoundRecord:
        spec = self.spec
        if round_idx != len(self.records):
            raise ValueError(
                f"rounds must run in order: expected {len(self.records)}, "
                f"got {round_idx}")
        if round_idx >= spec.rounds:
            raise ValueError(
                f"job {spec.job_id!r} has only {spec.rounds} rounds")
        # --- plan from predictions (the engine's policy reads the same
        # predictor/estimator state at its round start) ----------------------
        t_rnd_pred = self.engine.predictor.t_rnd()
        t_agg_pred = self.estimator.t_agg(spec)

        # --- real local training; measured arrival = train + comm ------------
        arrivals: Dict[str, float] = {}
        measured: Dict[str, Tuple[float, float]] = {}
        for pid, party in self.parties.items():
            res = party.local_round(self.global_params, self.epochs)
            comm = self.engine.predictor.t_comm(pid)
            measured[pid] = (res.train_time_s, comm)
            arrivals[pid] = res.train_time_s + comm
            self.queue.publish_update(
                spec.job_id, pid, res.update, round_idx, res.n_examples,
            )
        self.measured_rounds.append(measured)

        # --- replay this round's arrivals under the configured policy --------
        self.source.push_round(measured)
        cs0 = self.cluster.container_seconds_by_job.get(spec.job_id, 0.0)
        if round_idx == 0:
            self.engine.start()
        else:
            self.engine.release_round()
        self.sim.run()
        if round_idx not in self._round_done_t:
            raise RuntimeError(
                f"virtual replay did not complete round {round_idx} under "
                f"strategy {self.policy.strategy!r}")
        eng = self.engine
        done = self._round_done_t[round_idx]
        round_start = eng.round_start
        if self.policy.strategy == "jit" and self.policy.jit_policy == "fixed":
            trigger = max(0.0, t_rnd_pred - t_agg_pred)  # planned deploy
        elif eng.round_deploy_t is not None:
            trigger = eng.round_deploy_t - round_start  # first actual deploy
        else:
            trigger = 0.0  # always-on: no per-round deployment
        container_seconds = (
            self.cluster.container_seconds_by_job.get(spec.job_id, 0.0) - cs0
        )

        # --- real aggregation over the queue ---------------------------------
        n = self.agg.drain(round_idx)
        if n != spec.n_parties:
            raise RuntimeError(
                f"round {round_idx}: fused {n} updates, expected "
                f"{spec.n_parties}")
        self.global_params = self.agg.finish_round(
            self.global_params, round_idx, lr=spec.lr
        )
        rec = RoundRecord(
            round_idx=round_idx,
            arrivals=arrivals,
            t_rnd_pred=t_rnd_pred,
            t_agg_pred=t_agg_pred,
            trigger=trigger,
            completion=done - round_start,
            latency=eng.metrics.round_latencies[round_idx],
            container_seconds=container_seconds,
            global_loss=self.eval_loss(),
        )
        self.records.append(rec)
        return rec

    def metrics(self) -> JobMetrics:
        """§6.2 metrics of the virtual timeline over the real rounds, in the
        same shape the simulation vehicles produce (strategy per policy).
        Returns a snapshot — the engine's own metrics are never mutated, so
        this is safe to call between rounds."""
        eng = self.engine.metrics
        jid = self.spec.job_id
        cs = self.cluster.container_seconds_by_job.get(jid, 0.0)
        ao = getattr(self.engine.impl, "ao", None)
        if ao is not None:  # live always-on container (partial run): bill it
            cs += self.sim.now - ao.start_t
        finished = eng.finished_at
        if finished is None and self.records:
            finished = self._round_done_t[self.records[-1].round_idx]
        return dataclasses.replace(
            eng,
            round_latencies=list(eng.round_latencies),
            round_lateness=list(eng.round_lateness),
            predictions=[(r.t_rnd_pred, r.t_agg_pred) for r in self.records],
            n_deploys=self.cluster.n_deploys_by_job.get(jid, 0),
            container_seconds=cs,
            cost_usd=cs * self.cluster_cfg.price_per_container_s,
            finished_at=finished,
        )

    def run(self, rounds: Optional[int] = None, verbose: bool = True
            ) -> List[RoundRecord]:
        for r in range(rounds or self.spec.rounds):
            rec = self.run_round(r)
            if verbose:
                print(
                    f"round {r:3d} loss={rec.global_loss:7.4f} "
                    f"latency={rec.latency:6.3f}s "
                    f"container_s={rec.container_seconds:7.2f} "
                    f"(pred t_rnd={rec.t_rnd_pred:6.2f} "
                    f"actual={max(rec.arrivals.values()):6.2f})"
                )
        return self.records
