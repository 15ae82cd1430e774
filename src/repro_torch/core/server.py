"""FL orchestration (the port of ``repro.core.server``): runs an algorithm
for R communication rounds with periodic centralized evaluation,
collecting the histories the paper plots."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import prng

PyTree = Any


@dataclasses.dataclass
class History:
    rounds: list = dataclasses.field(default_factory=list)
    train_loss: list = dataclasses.field(default_factory=list)
    test_acc: list = dataclasses.field(default_factory=list)
    test_loss: list = dataclasses.field(default_factory=list)
    uplink_bits: list = dataclasses.field(default_factory=list)
    downlink_bits: list = dataclasses.field(default_factory=list)
    total_bits: list = dataclasses.field(default_factory=list)
    wall_s: list = dataclasses.field(default_factory=list)
    sim_time: list = dataclasses.field(default_factory=list)  # cumulative
    final_params: Optional[Any] = None  # set by run_federated on completion

    @property
    def best_acc(self) -> float:
        return max(self.test_acc) if self.test_acc else float("nan")


def make_eval_fn(apply_fn: Callable, x_test: torch.Tensor,
                 y_test: torch.Tensor, batch: int = 512):
    """Centralized eval on the held-out set; returns ``(loss, accuracy)``
    as python floats.  Like the reference, only whole batches count (the
    remainder batch is dropped)."""
    n = x_test.shape[0]
    num_b = max(1, n // batch)
    xbs = x_test[: num_b * batch].reshape((num_b, batch) + tuple(x_test.shape[1:]))
    ybs = y_test[: num_b * batch].reshape((num_b, batch)).to(torch.int64)

    @torch.no_grad()
    def eval_params(params):
        loss_sum = torch.zeros((), dtype=torch.float32, device=xbs.device)
        correct = torch.zeros((), dtype=torch.int64, device=xbs.device)
        for i in range(num_b):
            logits = apply_fn(params, xbs[i])
            logp = torch.log_softmax(logits, dim=-1)
            loss = -logp.gather(1, ybs[i].unsqueeze(1)).squeeze(1)
            loss_sum = loss_sum + loss.sum()
            correct = correct + (logits.argmax(dim=-1) == ybs[i]).sum()
        return (float(loss_sum / (num_b * batch)),
                float(correct.to(torch.float32) / (num_b * batch)))

    return eval_params


def run_federated(
    algorithm,
    params0: PyTree,
    num_rounds: int,
    key,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 10,
    policy: Optional[Any] = None,
    wire: Optional[str] = None,
) -> History:
    """Drive ``algorithm`` (anything with .init/.round/.meter) for R rounds,
    one ``algorithm.round`` per round on the ``key, sub = split(key)``
    chain, evaluating after round 1, every ``eval_every`` rounds, and
    after the last.  ``policy`` (an
    :class:`repro_torch.core.aggregation.AggregationPolicy`) rebinds the
    aggregation policy (DESIGN.md §7) and ``wire`` (``"account"`` |
    ``"packed"``) the wire mode (DESIGN.md §8) first."""
    if policy is not None:
        algorithm.set_policy(policy)
    if wire is not None:
        algorithm.set_wire(wire)
    key = prng.key_data(key)
    state = algorithm.init(params0)
    hist = History()
    t0 = time.time()
    sim_t = 0.0
    for r in range(num_rounds):
        key, sub = prng.split(key, 2)
        state, metrics = algorithm.round(state, sub)
        sim_t += metrics.get("sim_time", 0.0)
        if eval_fn is not None and (r % eval_every == 0 or r == num_rounds - 1):
            tl, ta = eval_fn(state.x)
            hist.rounds.append(r + 1)
            hist.train_loss.append(metrics.get("train_loss", float("nan")))
            hist.test_loss.append(float(tl))
            hist.test_acc.append(float(ta))
            hist.uplink_bits.append(algorithm.meter.uplink_bits)
            hist.downlink_bits.append(algorithm.meter.downlink_bits)
            hist.total_bits.append(algorithm.meter.total_bits)
            hist.wall_s.append(time.time() - t0)
            hist.sim_time.append(sim_t)
    hist.final_params = state.x
    return hist
