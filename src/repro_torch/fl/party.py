"""Party runtime: real local training with autograd (weights for
FedAvg/FedProx, gradients for FedSGD), with the timing measurements that
§5.2 requires parties to report (epoch time, minibatch time, dataset
size). On the card the clock is read only after ``torch.cuda.synchronize``:
these times drive the schedule, and the launches are asynchronous."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch import Pytree, get_device, tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.data.loader import Loader
from repro_torch.models import model as M
from repro_torch.optim import sgd


@dataclasses.dataclass
class LocalResult:
    update: Pytree  # weights (fedavg/fedprox) or gradients (fedsgd)
    n_examples: int
    train_time_s: float  # measured wall time (what the party reports)
    minibatch_time_s: float
    loss: float


class Party:
    def __init__(
        self,
        party_id: str,
        cfg: ModelConfig,
        data: Dict[str, np.ndarray],
        *,
        algorithm: str = "fedavg",
        batch_size: int = 16,
        lr: float = 0.05,
        prox_mu: float = 0.0,
        seed: int = 0,
        device: Union[str, torch.device, None] = None,
    ):
        self.party_id = party_id
        self.cfg = cfg
        self.algorithm = algorithm
        self.device = get_device(device)
        self.loader = Loader(data, batch_size, seed=seed)
        self.n_examples = self.loader.n
        self.lr = lr
        self.prox_mu = prox_mu
        self._opt = sgd(lr)

    # ---- steps --------------------------------------------------------------
    def _loss(self, params, batch, global_params):
        loss, metrics = M.loss_fn(self.cfg, params, batch)
        if self.algorithm == "fedprox" and self.prox_mu > 0:
            # FedProx: + mu/2 * ||w - w_global||^2 on the PARTY objective
            sq = sum(
                torch.sum(torch.square(p.to(torch.float32) -
                                       g.to(torch.float32)))
                for p, g in zip(tree_leaves(params),
                                tree_leaves(global_params))
            )
            loss = loss + 0.5 * self.prox_mu * sq
        return loss, metrics

    def _grads(self, params, loss_of) -> Tuple[Pytree, torch.Tensor]:
        """(d loss / d params, loss) for a loss of the parameter tree; zeros
        for a leaf the loss does not reach (a MoE router's correction bias,
        which only chooses the experts), as ``jax.grad`` gives."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_of(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return tree_unflatten(params, list(grads)), loss.detach()

    def _step(self, params, opt_state, batch, global_params):
        grads, loss = self._grads(
            params, lambda p: self._loss(p, batch, global_params)[0])
        params, opt_state = self._opt.update(grads, opt_state, params)
        return params, opt_state, loss

    def _grad_step(self, params, batch):
        return self._grads(params, lambda p: M.loss_fn(self.cfg, p, batch)[0])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- §5.2 timing report: measure one minibatch (after a warmup) ---------
    def calibrate(self, global_params: Pytree) -> Tuple[float, float]:
        """Returns (minibatch_time_s, epoch_time_s estimate)."""
        batch = self._to_device(next(self.loader.epoch(shuffle=False)))
        opt_state = self._opt.init(global_params)
        if self.algorithm == "fedsgd":
            def run():
                return self._grad_step(global_params, batch)
        else:
            def run():
                return self._step(global_params, opt_state, batch,
                                  global_params)
        run()  # warmup
        self._sync()
        t0 = time.perf_counter()
        run()
        self._sync()
        t_mb = time.perf_counter() - t0
        return t_mb, t_mb * len(self.loader)

    # ---- one FL round of local work ----------------------------------------------
    def local_round(self, global_params: Pytree, epochs: int = 1
                    ) -> LocalResult:
        t0 = time.perf_counter()
        n_batches = 0
        last_loss = 0.0
        if self.algorithm == "fedsgd":
            # one pass, average gradients (classic FedSGD)
            acc = None
            for batch in self.loader.epoch():
                grads, loss = self._grad_step(global_params,
                                              self._to_device(batch))
                acc = grads if acc is None else tree_map(torch.add, acc, grads)
                n_batches += 1
                last_loss = float(loss)
            update = tree_map(lambda g: g / n_batches, acc)
        else:
            params = global_params
            opt_state = self._opt.init(params)
            for _ in range(epochs):
                for batch in self.loader.epoch():
                    params, opt_state, loss = self._step(
                        params, opt_state, self._to_device(batch),
                        global_params)
                    n_batches += 1
                    last_loss = float(loss)
            update = params
        self._sync()
        dt = time.perf_counter() - t0
        return LocalResult(
            update=update,
            n_examples=self.n_examples,
            train_time_s=dt,
            minibatch_time_s=dt / max(n_batches, 1),
            loss=last_loss,
        )

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v, np.int64)).to(self.device)
                for k, v in batch.items()}
