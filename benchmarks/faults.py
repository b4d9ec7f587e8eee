"""Faults planted under the timed path, each of which must turn a run's
``correct`` false: a step that returns its state unchanged, half of the
batch left out (its rows given the other half's evaluations), an answer
altered where it is produced, and one game's evaluation dropped (which a
quantile over the games would not see).  ``tests/test_bench_control.py``
plants each under a tiny run on the CPU; ``control.py --fault`` reads each
at a cell's own size on the card."""

from __future__ import annotations

import contextlib

import torch


def _unchanged_step(orig):
    return lambda state, action, dice, cfg, u_card=None: state


def _half_batch_eval(make):
    """The network evaluates the first half of the rows; the second half
    gets the first half's outputs."""
    def factory(*a, **kw):
        fast = make(*a, **kw)

        def eval_fn(folded, state, legal):
            p, v = fast(folded, state, legal)
            h = p.shape[0] // 2
            return (torch.cat([p[:h], p[:p.shape[0] - h]]),
                    torch.cat([v[:h], v[:v.shape[0] - h]]))
        return eval_fn
    return factory


def _one_eval_dropped(make):
    """Game 0's evaluation is dropped: a uniform prior over its legal
    moves and a value of 0."""
    def factory(*a, **kw):
        fast = make(*a, **kw)

        def eval_fn(folded, state, legal):
            p, v = fast(folded, state, legal)
            p, v = p.clone(), v.clone()
            m = legal[0].to(p.dtype)
            p[0] = m / m.sum()
            v[0] = 0
            return p, v
        return eval_fn
    return factory


def _altered_pick(orig):
    def pick_move(result, state, cfg, sample, gumbel=None):
        a = orig(result, state, cfg, sample, gumbel).clone()
        a[0] = (a[0] + 1) % 43
        return a
    return pick_move


def _sites():
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.mcts import search
    from alphazero_risk_tpu_torch.training import trainer
    return {
        "play": {
            "state_unchanged": (rules, "step", _unchanged_step),
            "half_batch": (trainer, "make_fast_eval_fn", _half_batch_eval),
            "answer_altered": (search, "pick_move", _altered_pick),
            "one_eval_dropped": (trainer, "make_fast_eval_fn",
                                 _one_eval_dropped),
        },
    }


def names(driver: str) -> list:
    return sorted(_sites()[driver])


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """Inside the block the program runs with ``fault``."""
    mod, name, make = _sites()[driver][fault]
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)
