"""Port parity: the ScriptPlayer step and the match tallies.

Script-vs-script games in both packages with identical ``u`` and dice
(the explicit-randomness contract of ``agents/common.py``): state, carry,
recorded action and record mask must be bit-identical after every step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.agents import script_agent as JSA
from alphazero_risk_tpu.agents.driver import MatchResult as JMatch
from alphazero_risk_tpu.agents.driver import summarize as j_summarize
from alphazero_risk_tpu.env.state import new_game as j_new_game

from alphazero_risk_tpu_torch.agents import script_agent as TSA
from alphazero_risk_tpu_torch.agents.common import (draw_step_randoms,
                                                    first_set_bit,
                                                    masked_choice)
from alphazero_risk_tpu_torch.agents.driver import MatchResult, summarize
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env import state as TS

torch.set_num_threads(1)


def _port(x):
    return torch.from_numpy(np.array(x))


def _new_games(seed, b, cfg):
    """Fresh JAX deals and their port copies; under full cards with hands
    and piles dealt by ``driver.force_card_cases`` (numpy ``seed``), so
    that trades come early."""
    from alphazero_risk_tpu.env.state import GameState as JState
    from alphazero_risk_tpu_torch.agents.driver import force_card_cases
    js = j_new_game(jax.random.PRNGKey(seed), b)
    ts = TS.GameState(**{f.name: _port(getattr(js, f.name))
                         for f in dataclasses.fields(TS.GameState)})
    if not cfg.simple_cards:
        ts = force_card_cases(ts, np.random.default_rng(seed), cfg)
        js = JState(**{f.name: jnp.asarray(getattr(ts, f.name).numpy())
                       for f in dataclasses.fields(TS.GameState)})
    return js, ts


@pytest.mark.parametrize("seed,cfg", [
    (0, Config()),
    (1, Config(limit_reinforcement_moves=False)),
    pytest.param(2, Config(simple_cards=False), id="2-full-cards"),
])
def test_script_step_bit_exact(seed, cfg):
    b, steps = 8, 500 if cfg.simple_cards else 300
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(seed)
    js, ts = _new_games(seed, b, cfg)
    jcar, tcar = JSA.init_carry(b), TSA.init_carry(b, "cpu")
    jprev = jnp.full((b,), -1, jnp.int32)
    tprev = torch.full((b,), -1, dtype=torch.int32)
    jstep = jax.jit(JSA.script_step_recorded, static_argnums=5)
    phases = set()
    for t in range(steps):
        u = rng.random((b, 4)).astype(np.float32)
        dice = rng.integers(1, 7, (b, 5)).astype(np.int32)
        jreset = js.cur_player != jprev
        treset = ts.cur_player != tprev
        jprev, tprev = js.cur_player, ts.cur_player
        phases.update(np.asarray(js.phase).tolist())
        js, jcar, (ja, jr) = jstep(js, jcar, jreset, jnp.asarray(u),
                                   jnp.asarray(dice), jc)
        ts, tcar, (ta, tr) = TSA.script_step_recorded(
            ts, tcar, treset, torch.from_numpy(u), torch.from_numpy(dice),
            cfg)
        for f in dataclasses.fields(TS.GameState):
            np.testing.assert_array_equal(
                getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
                err_msg=f"step {t} field {f.name}")
        for f in dataclasses.fields(TSA.ScriptCarry):
            np.testing.assert_array_equal(
                getattr(tcar, f.name).numpy(),
                np.asarray(getattr(jcar, f.name)),
                err_msg=f"step {t} carry {f.name}")
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert phases == set(range(6)), phases
    if not cfg.simple_cards:         # a full trade happened
        assert (ts.card_sets_played > 0).any()


def test_masked_choice_and_first_set_bit():
    from alphazero_risk_tpu.agents.common import (
        first_set_bit as j_first, masked_choice as j_choice)
    rng = np.random.default_rng(3)
    mask = rng.random((256, 42)) < 0.2
    mask[:8] = False                       # empty masks choose 0
    u = rng.random(256).astype(np.float32)
    u[8:16] = np.nextafter(np.float32(1), np.float32(0))
    np.testing.assert_array_equal(
        masked_choice(torch.from_numpy(mask), torch.from_numpy(u)).numpy(),
        np.asarray(j_choice(jnp.asarray(mask), jnp.asarray(u))))
    np.testing.assert_array_equal(
        first_set_bit(torch.from_numpy(mask)).numpy(),
        np.asarray(j_first(jnp.asarray(mask))))


def test_draw_step_randoms_contract():
    u, dice = draw_step_randoms(torch.Generator().manual_seed(0), 64, "cpu")
    assert u.shape == (64, 4) and u.dtype == torch.float32
    assert ((u >= 0) & (u < 1)).all()
    assert dice.shape == (64, 5) and dice.dtype == torch.int32
    assert ((dice >= 1) & (dice <= 6)).all()


def test_summarize_matches():
    rng = np.random.default_rng(0)
    status = rng.integers(-2, 2, 32).astype(np.int32)
    started = rng.integers(0, 2, 32).astype(np.int32)
    ref = j_summarize(JMatch(status=jnp.asarray(status), rounds=None,
                             steps=None, started_by=jnp.asarray(started)))
    out = summarize(MatchResult(status=torch.from_numpy(status), rounds=None,
                                steps=0, started_by=torch.from_numpy(started)))
    assert out == ref


@pytest.mark.parametrize("seed,cfg", [
    (0, Config()),
    (1, Config(limit_attack_moves=True, fast_attack_mobilization=False)),
    pytest.param(2, Config(simple_cards=False), id="2-full-cards"),
])
def test_random_step_bit_exact(seed, cfg):
    """The RandomPlayer under the ``u[B,4]`` / ``dice[B,5]`` contract:
    state, recorded action and record mask bit-identical after every step,
    through all six phases."""
    from alphazero_risk_tpu.agents import random_agent as JRA
    from alphazero_risk_tpu_torch.agents import random_agent as TRA
    b, steps = 8, 400 if cfg.simple_cards else 250
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(seed + 10)
    js, ts = _new_games(seed, b, cfg)
    jstep = jax.jit(JRA.random_step_recorded, static_argnums=3)
    phases = set()
    for t in range(steps):
        u = rng.random((b, 4)).astype(np.float32)
        dice = rng.integers(1, 7, (b, 5)).astype(np.int32)
        phases.update(np.asarray(js.phase).tolist())
        js, (ja, jr) = jstep(js, jnp.asarray(u), jnp.asarray(dice), jc)
        ts, (ta, tr) = TRA.random_step_recorded(
            ts, torch.from_numpy(u), torch.from_numpy(dice), cfg)
        for f in dataclasses.fields(TS.GameState):
            np.testing.assert_array_equal(
                getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
                err_msg=f"step {t} field {f.name}")
        assert ta.dtype == torch.int32
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert phases == set(range(6)), phases
    if not cfg.simple_cards:         # a full trade happened
        assert (ts.card_sets_played > 0).any()


@pytest.mark.parametrize("agents", [(0, 1), (1, 1), (1, 0)])
def test_play_match_to_the_end(agents):
    """``play_match`` with script and random seats: every game ends, and
    the tallies add up."""
    from alphazero_risk_tpu_torch.agents import driver as TD
    gen = torch.Generator().manual_seed(agents[0] * 2 + agents[1])
    state = TD.mirrored_initial_states(4, generator=gen, device="cpu")
    res = TD.play_match(gen, state, agents[0], agents[1], Config(), 4000)
    out = TD.summarize(res)
    assert out["games"] == 4 and out["unfinished"] == 0
    assert out["p0_wins"] + out["p1_wins"] + out["draws"] == 4
    assert 0 < res.steps < 4000
    if agents == (0, 1):         # the ScriptPlayer beats the RandomPlayer
        assert out["p0_wins"] >= 3
