"""Learner: loss, optimizer, and epoch training.

Port of ``alphazero_risk_tpu/training/learner.py`` (reference
``alphazero_nn.cpp:351-410``): shuffled minibatch Adam epochs over the
replay buffer (``make_epoch_fn``) or over the valid window of the device
ring (``make_ring_epoch_fn``), loss = softmax-CE(policy) + MSE(value) +
1e-3 L2 (``build_graph.py:92-103``).

The train state is an ``AZNet`` (parameters and BatchNorm running
statistics, updated in place by a training-mode forward) with its Adam
optimizer.  ``torch.optim.Adam`` at its defaults is optax's ``adam``: b1
0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected.  The L2 term is
part of the loss (``l2_coeff * sum(w**2)``), not weight decay.  The
network's convolutions and products go to PyTorch's own, as the JAX learner
leaves them to XLA.

In a process world (``parallel/distributed.py``) each rank's ``update``
takes its rows of the global minibatch and the update is the one of the
concatenated batch, as under JAX's GSPMD: BatchNorm normalizes with the
world's statistics (``models/resnet.py``), the gradients are all-reduced
as one flat buffer and divided by the world's size (the gradient of the
global mean loss, the L2 term counted once), and the step's losses are
world means.  Adam's state stays equal on every rank because the
gradients are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..models.resnet import AZNet, build_network
from ..parallel import distributed as D


@dataclasses.dataclass
class TrainState:
    step: int
    net: AZNet
    opt: torch.optim.Adam


def create_train_state(cfg: Config, seed: int = 0,
                       device="cuda") -> TrainState:
    net = build_network(cfg, resolve_device(device), seed=seed)
    return train_state_of(net, cfg)


def train_state_of(net: AZNet, cfg: Config, step: int = 0) -> TrainState:
    """A fresh train state (zero Adam moments) around ``net``."""
    opt = torch.optim.Adam(net.parameters(), lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(step=step, net=net, opt=opt)


def kernel_parameters(net: AZNet):
    """The conv and dense kernels: what the L2 term regularizes (BatchNorm
    scales and all biases are not, as in the reference)."""
    return [m.weight for m in net.modules()
            if isinstance(m, (nn.Conv2d, nn.Linear))]


def l2_penalty(net: AZNet) -> torch.Tensor:
    """tf.keras.regularizers.l2 semantics: sum(w**2) over conv/dense
    kernels."""
    return sum(torch.sum(torch.square(w.to(torch.float32)))
               for w in kernel_parameters(net))


def loss_fn(net: AZNet, cfg: Config, batch: Dict[str, torch.Tensor]):
    """Training-mode forward and the three loss terms.  Returns
    ``(total, aux)``; the BatchNorm running statistics of ``net`` move as a
    side effect."""
    logits, value = net(batch["features"], training=True)
    logp = torch.log_softmax(logits, dim=-1)
    pi_loss = -(batch["policy"] * logp).sum(-1).mean()
    v_loss = torch.mean(torch.square(value - batch["value"]))
    l2 = cfg.l2_coeff * l2_penalty(net)
    total = pi_loss + v_loss + l2
    return total, {"pi_loss": pi_loss, "v_loss": v_loss, "l2": l2}


def _world_mean_(params, metrics: torch.Tensor) -> torch.Tensor:
    """Replace every gradient and the ``metrics`` by their world means, in
    one all-reduce of one flat buffer.  Returns the metrics' means."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [metrics])
    D.all_reduce_(flat).div_(D.world())
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return flat[i:]


def update(state: TrainState, cfg: Config, batch: Dict[str, torch.Tensor]):
    """One Adam step on one minibatch, in place on ``state`` (in a process
    world, on this rank's rows of the global minibatch)."""
    state.opt.zero_grad(set_to_none=True)
    total, aux = loss_fn(state.net, cfg, batch)
    total.backward()
    metrics = torch.stack([total.detach(), aux["pi_loss"].detach(),
                           aux["v_loss"].detach()]).to(torch.float32)
    if D.world() > 1:
        metrics = _world_mean_(list(state.net.parameters()), metrics)
    state.opt.step()
    state.step += 1
    return state, {"loss": metrics[0], "pi_loss": metrics[1],
                   "v_loss": metrics[2]}


def _minibatches(state: TrainState, cfg: Config, data, perm: torch.Tensor,
                 prepare_batch: Callable):
    """One update per row of ``perm`` ([steps, batch_size] indices into
    ``data``).  Returns the means over the steps of ``loss``, ``pi_loss``
    and ``v_loss`` (NaN when no step runs) and ``first_pi_loss``, the
    policy loss of the first minibatch taken before its update."""
    nan = torch.tensor(float("nan"), device=perm.device)
    sums: Dict[str, torch.Tensor] = {}
    first = nan
    for i, idx in enumerate(perm):
        state, m = update(state, cfg, prepare_batch(data, idx))
        if i == 0:
            first = m["pi_loss"]
        for k, v in m.items():
            sums[k] = sums[k] + v if k in sums else v
    nb = perm.shape[0]
    keys = ("loss", "pi_loss", "v_loss")
    return state, {**{k: sums[k] / nb if nb else nan for k in keys},
                   "first_pi_loss": first}


def _gather_batch(data, idx):
    return {k: v[idx] for k, v in data.items()}


def make_epoch_fn(cfg: Config, prepare_batch: Optional[Callable] = None):
    """One epoch = shuffle + one update per minibatch.

    Mirrors reference ``AlphaZeroNN::train`` (alphazero_nn.cpp:351-410):
    per-epoch reshuffle, ``N // batch_size`` batches (remainder dropped),
    returns the epoch's mean losses as 0-d tensors, and under
    ``first_pi_loss`` the policy loss of its first minibatch (taken before
    that minibatch's update).

    ``epoch(state, data, generator=None, perm=None)``: ``data`` is a dict of
    ``[N, ...]`` tensors; ``perm`` ([N] int64) gives the shuffle explicitly,
    otherwise it is drawn from ``generator``.  ``prepare_batch(data, idx)
    -> {features, policy, value}`` lets callers keep the replay compact and
    expand feature planes per minibatch.
    """
    prepare_batch = prepare_batch or _gather_batch

    def epoch(state: TrainState, data: Dict[str, Any],
              generator: torch.Generator | None = None,
              perm: torch.Tensor | None = None):
        first = next(iter(data.values()))
        n, dev = first.shape[0], first.device
        nb = n // cfg.batch_size
        if perm is None:
            perm = torch.randperm(n, generator=generator,
                                  device=generator.device)
        perm = perm[: nb * cfg.batch_size].to(dev).reshape(
            nb, cfg.batch_size)
        return _minibatches(state, cfg, data, perm, prepare_batch)

    return epoch


def make_ring_epoch_fn(cfg: Config, prepare_batch: Optional[Callable] = None):
    """``make_epoch_fn`` over the device-resident ring
    (``device_replay.DeviceReplay``).

    ``data`` holds ``cap`` physical slots of which the logical window
    ``[start, start + size) mod cap`` is valid.  One uniform vector
    ``r[cap]`` orders the window: ``argsort(r + (slot >= size))`` (stable,
    as JAX's) puts the valid logical slots first in random order, each is
    mapped to its physical slot ``(start + i) % cap``, and ``size //
    batch_size`` updates run on them.  Nothing is uploaded.

    ``epoch(state, data, start, size, generator=None, r=None)``: ``r``
    ([cap] float32) gives the uniforms explicitly, otherwise they are drawn
    from ``generator``.  Returns the metrics of ``make_epoch_fn`` (NaN
    losses when no step runs).
    """
    prepare_batch = prepare_batch or _gather_batch

    def epoch(state: TrainState, data: Dict[str, Any], start: int,
              size: int, generator: torch.Generator | None = None,
              r: torch.Tensor | None = None):
        first = next(iter(data.values()))
        cap, dev = first.shape[0], first.device
        steps = size // cfg.batch_size
        if r is None:
            r = torch.rand((cap,), generator=generator,
                           device=generator.device)
        r = r.to(dev)
        invalid = torch.arange(cap, device=dev) >= size
        order = torch.argsort(r + invalid.to(r.dtype), stable=True)
        phys = (start + order[: steps * cfg.batch_size]) % cap
        return _minibatches(state, cfg, data,
                            phys.reshape(steps, cfg.batch_size),
                            prepare_batch)

    return epoch


def make_predict_fn(cfg: Config):
    """Batched inference with invalid-move masking + renormalization
    (reference ``NNOutputData::normalize``, alphazero_nn_data.cpp:3-27)."""

    @torch.no_grad()
    def predict(net: AZNet, features: torch.Tensor,
                legal_mask: torch.Tensor):
        logits, value = net(features)
        neg_inf = torch.tensor(float("-inf"), device=logits.device)
        probs = torch.softmax(torch.where(legal_mask, logits, neg_inf),
                              dim=-1)
        return probs, value

    return predict
