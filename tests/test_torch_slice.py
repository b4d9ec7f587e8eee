"""Port parity of the slice: the AlphaZero-vs-ScriptPlayer actor loop.

``run_episodes`` (versus, argmax moves, opponent fast-forward, chunked
``carry_in``/``prev_in``) in both packages with the same fake network and
every random draw injected: the harness replays the JAX key chain of
``actor.run_episodes`` (a 5-way split per step, ``kff`` for the
fast-forward, ``k_mcts`` for the search, ``k_dice`` for the move) and hands
the port the same numbers.  Then the port's ``Trainer.play`` runs a tiny
config to the end with the real folded int8 network on the plain kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.agents import script_agent as JSA
from alphazero_risk_tpu.agents.common import draw_step_randoms
from alphazero_risk_tpu.agents.driver import mirrored_initial_states
from alphazero_risk_tpu.training import actor as JA

from alphazero_risk_tpu_torch.agents import script_agent as TSA
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env import state as TS
from alphazero_risk_tpu_torch.training import actor as TA
from alphazero_risk_tpu_torch.training.trainer import Trainer

from test_torch_mcts import jax_eval, port_eval, search_gumbel

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


class JaxChainDraws:
    """The draws of one JAX ``run_episodes`` call, from its key."""

    def __init__(self, key, cfg, batch):
        self.key, self.cfg, self.b = key, cfg, batch

    def begin_step(self):
        self.key, self.k_mcts, _, self.k_dice, _ = jax.random.split(
            self.key, 5)
        self.key, self.kff = jax.random.split(self.key)

    def ff(self):
        self.kff, ko = jax.random.split(self.kff)
        u, dice = draw_step_randoms(ko, self.b)
        return _t(u), _t(dice)

    def gumbel(self):
        return search_gumbel(self.k_mcts, self.cfg.mcts_simulations,
                             self.cfg.max_depth, self.b)

    def az_dice(self):
        kd, _ = jax.random.split(self.k_dice)
        return _t(jax.random.randint(kd, (self.b, 5), 1, 7,
                                     dtype=jnp.int32))


def test_run_episodes_matches_jax():
    cfg = Config(mcts_simulations=4, max_depth=8)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    b, chunk = 4, 30
    js = mirrored_initial_states(jax.random.PRNGKey(3), b)
    ts = TS.GameState(**{f.name: _t(getattr(js, f.name))
                         for f in dataclasses.fields(TS.GameState)})
    run = jax.jit(lambda s, k, c, p: JA.run_episodes(
        jax_eval, s, k, jc, chunk, opponent=JA.OPP_SCRIPT,
        az_seats=(True, False), sample_moves=False, record_all=False,
        carry_in=c, prev_in=p))
    jcar, jprev = JSA.init_carry(b), jnp.full((b,), -1, jnp.int32)
    tcar, tprev = None, None
    for c, key in enumerate(jax.random.split(jax.random.PRNGKey(9), 2)):
        jout = run(js, key, jcar, jprev)
        tout = TA.run_episodes(port_eval, ts, JaxChainDraws(key, cfg, b),
                               cfg, chunk, carry_in=tcar, prev_in=tprev)
        js, jcar, jprev = jout.state, jout.carry, jout.prev_player
        ts, tcar, tprev = tout.state, tout.carry, tout.prev_player
        for f in dataclasses.fields(TS.GameState):
            np.testing.assert_array_equal(
                getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
                err_msg=f"chunk {c} field {f.name}")
        for f in dataclasses.fields(TSA.ScriptCarry):
            np.testing.assert_array_equal(
                getattr(tcar, f.name).numpy(),
                np.asarray(getattr(jcar, f.name)),
                err_msg=f"chunk {c} carry {f.name}")
        np.testing.assert_array_equal(tout.status.numpy(),
                                      np.asarray(jout.status))
        np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
    # both seats moved: the games left setup and reached the battle phases
    assert (ts.round > 28).all() and int(tout.az_decisions) > 0


def test_trainer_play_int8_to_the_end():
    """The slice's entry point on the CPU at a tiny width: the folded,
    quantized and calibrated int8 network (plain K1) and plain K2/K3."""
    cfg = Config(blocks=2, filters=32, value_hidden=16, mcts_simulations=4,
                 max_depth=8, env_batch_per_device=4, actor_chunk_steps=64,
                 fast_infer=True, fast_infer_int8=True)
    trainer = Trainer(cfg, seed=0, device="cpu")
    assert "act_s" in trainer.folded()
    res = trainer.play(TA.OPP_SCRIPT, 3)          # rounded up to a pair
    assert res["games"] == 4 and res["unfinished"] == 0
    assert res["p0_wins"] + res["p1_wins"] + res["draws"] == 4
    assert trainer.play_stats["az_decisions"] > 0
