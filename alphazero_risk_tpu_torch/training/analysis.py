"""Analysis mode: k-fold cross-validation over saved training samples.

Port of ``alphazero_risk_tpu/training/analysis.py``, after reference
``AlphaZeroNN::trainCrossValidation`` (alphazero_nn.cpp:412-577): split the
sample store into k folds, train fresh weights on k-1 folds with dynamic
epochs (stop after ``patience`` epochs without a ``threshold`` relative
improvement of the validation loss), report per-fold validation losses.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from . import actor as A
from .learner import TrainState, create_train_state, make_epoch_fn
from .replay import ReplayBuffer


@torch.no_grad()
def _val_losses(state: TrainState, cfg: Config, data, batch_size: int):
    """Mean policy cross-entropy and value MSE of the network in inference
    mode over ``n // batch_size`` consecutive minibatches (one partial
    batch when ``n < batch_size``)."""
    n = next(iter(data.values())).shape[0]
    nb = max(n // batch_size, 1)
    pi_total = v_total = 0.0
    for i in range(nb):
        sub = {k: v[i * batch_size:min((i + 1) * batch_size, n)]
               for k, v in data.items()}
        logits, value = state.net(A.features_of_samples(
            A.SampleBatch(valid=None, **sub), cfg), training=False)
        logp = torch.log_softmax(logits, -1)
        pi_total += float(-(sub["policy"].to(torch.float32) * logp)
                          .sum(-1).mean())
        v_total += float(torch.mean(torch.square(value - sub["value"])))
    return pi_total / nb, v_total / nb


def cross_validate(cfg: Config, samples_path: str, folds: int = 5,
                   max_epochs: int = 30, seed: int = 0, patience: int = 3,
                   threshold: float = 0.01, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   init_states: Optional[Sequence[TrainState]] = None,
                   perms: Optional[Sequence[Sequence[torch.Tensor]]] = None
                   ) -> Dict:
    """k-fold cross-validation of fresh networks on the buffer file at
    ``samples_path``.

    The folds split a numpy permutation drawn from ``seed`` (JAX's split);
    fold f trains weights from ``create_train_state(cfg, seed + f)``.  For
    tests, ``init_states[f]`` gives fold f's initial train state and
    ``perms[f][e]`` its epoch e's shuffle; otherwise the shuffles are drawn
    from ``generator`` (by default one seeded with ``seed`` on
    ``device``).  Returns ``{"folds": [{fold, best_val, epochs, history}],
    "samples": n}``, or ``{"error": ...}`` when the file is missing.
    """
    dev = resolve_device(device)
    buf = ReplayBuffer(cfg)
    if not buf.load(samples_path):
        return {"error": f"no samples at {samples_path}"}
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    n = len(buf)
    perm = np.random.default_rng(seed).permutation(n)
    fold_size = n // folds
    data_all = {k: torch.from_numpy(v).to(dev) for k, v in buf.data.items()}
    epoch = make_epoch_fn(
        cfg, prepare_batch=lambda d, idx: A.prepare_samples(d, idx, cfg))
    report = {"folds": [], "samples": n}
    for f in range(folds):
        lo, hi = f * fold_size, (f + 1) * fold_size
        val_idx = torch.from_numpy(perm[lo:hi]).to(dev)
        train_idx = torch.from_numpy(
            np.concatenate([perm[:lo], perm[hi:]])).to(dev)
        dtrain = {k: v[train_idx] for k, v in data_all.items()}
        dval = {k: v[val_idx] for k, v in data_all.items()}
        state = (init_states[f] if init_states is not None
                 else create_train_state(cfg, seed + f, dev))
        best, stale, history = float("inf"), 0, []
        for e in range(max_epochs):
            state, _ = epoch(state, dtrain, generator=generator,
                             perm=None if perms is None else perms[f][e])
            pi_l, v_l = _val_losses(state, cfg, dval, cfg.batch_size)
            total = pi_l + v_l
            history.append({"epoch": e, "val_pi": pi_l, "val_v": v_l})
            if total < best * (1 - threshold):
                best, stale = total, 0
            else:
                stale += 1
                if stale >= patience:
                    break
        report["folds"].append({"fold": f, "best_val": best,
                                "epochs": len(history),
                                "history": history})
    return report
