"""Port parity of the agents' multi-step path on the CPU.

``blocks.agent_steps`` runs each game up to k steps while its stop
predicate is false (the opponent fast-forward's: the game ended or an
AlphaZero seat is to move; a match's: the game ended), the kind of the
seat to move picking the ScriptPlayer or the RandomPlayer, and
``run_agent_blocks`` drives it in blocks of draws with one host sync per
block, putting unused draws back.  On CPU tensors the plain multi-step
function runs; these tests hold it against JAX's ``script_step_recorded``
and ``random_step_recorded`` iterated under the same predicates with the
same draws (``ff_cond`` / ``ff_body``, ``play_match``'s body), and hold
the block bookkeeping and the generator rewind against the per-iteration
loops they replace: the results, the records, the step counts and the
generator's state after the call do not depend on the block size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.agents import random_agent as JRA
from alphazero_risk_tpu.agents import script_agent as JSA
from alphazero_risk_tpu.agents.common import draw_step_randoms as j_draws
from alphazero_risk_tpu.env import rules as JR
from alphazero_risk_tpu.env.state import GameState as JState
from alphazero_risk_tpu.env.state import tree_select as j_select

from alphazero_risk_tpu_torch.agents import blocks as TB
from alphazero_risk_tpu_torch.agents import driver as TD
from alphazero_risk_tpu_torch.agents import random_agent as TRA
from alphazero_risk_tpu_torch.agents import script_agent as TSA
from alphazero_risk_tpu_torch.agents.common import (BlockDraws,
                                                    draw_step_randoms)
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env import rules as TR
from alphazero_risk_tpu_torch.env import state as TS
from alphazero_risk_tpu_torch.training import actor as TA

from test_torch_mcts import port_eval

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mixed():
    """320 states of mixed Script/Random play (every phase, finished
    games) with their carries and previous movers."""
    mx = TD.mixed_play(16, 480, Config(), torch.Generator().manual_seed(7),
                       every=25)
    assert set(mx.state.phase.tolist()) == set(range(6))
    assert bool((TR.game_status(mx.state, Config()) != -1).any())
    return mx


def _jax(x):
    return jnp.asarray(x.numpy())


def _jax_state(ts):
    return JState(**{f.name: _jax(getattr(ts, f.name))
                     for f in dataclasses.fields(TS.GameState)})


def _jax_steps(state, carry, prev, u, dice, cfg, kinds):
    """JAX's ``script_step_recorded`` and ``random_step_recorded``
    iterated as ``ff_body`` and ``play_match``'s body iterate them (each
    seat's agent steps every game, a game takes its mover's state, and its
    mover's carry: the RandomPlayer returns it as it was), each game while
    its predicate is false: the JAX reference of ``agent_steps``, with the
    step counts."""
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    sstep = jax.jit(JSA.script_step_recorded, static_argnums=5)
    rstep = jax.jit(JRA.random_step_recorded, static_argnums=3)
    js, jprev = _jax_state(state), _jax(prev)
    jcar = JSA.ScriptCarry(*(_jax(getattr(carry, f.name))
                             for f in dataclasses.fields(TSA.ScriptCarry)))
    n = np.zeros(state.batch_size, np.int32)
    for j in range(u.shape[0]):
        kind = jnp.where(js.cur_player == 0, kinds[0], kinds[1])
        moving = (kind != TB.OPP_AZ) & (JR.game_status(js, jc) == -1)
        uj, dj = _jax(u[j]), _jax(dice[j])
        s2, c2 = js, jcar
        if TB.OPP_RANDOM in kinds:
            s2, _ = rstep(js, uj, dj, jc)
        if TB.OPP_SCRIPT in kinds:
            ss, cs, _ = sstep(js, jcar, js.cur_player != jprev, uj, dj, jc)
            is_script = kind == TB.OPP_SCRIPT
            s2 = j_select(is_script, ss, s2)
            c2 = j_select(is_script, cs, jcar)
        jprev = jnp.where(moving, js.cur_player, jprev)
        js = j_select(moving, s2, js)
        jcar = j_select(moving, c2, jcar)
        n += np.asarray(moving)
    return js, jcar, jprev, n


def _jax_chain_draws(key, k, b):
    """k iterations' draws of the fast-forward's key chain."""
    us, dice = [], []
    for _ in range(k):
        key, ko = jax.random.split(key)
        u, d = j_draws(ko, b)
        us.append(torch.from_numpy(np.array(u)))
        dice.append(torch.from_numpy(np.array(d)))
    return torch.stack(us), torch.stack(dice)


def _assert_equal(got, ref, msg):
    ts, tcar, tprev, tn = got
    js, jcar, jprev, jn = ref
    for f in dataclasses.fields(TS.GameState):
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(),
                                      np.asarray(getattr(js, f.name)),
                                      err_msg=f"{msg} field {f.name}")
    for f in dataclasses.fields(TSA.ScriptCarry):
        np.testing.assert_array_equal(getattr(tcar, f.name).numpy(),
                                      np.asarray(getattr(jcar, f.name)),
                                      err_msg=f"{msg} carry {f.name}")
    np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
    np.testing.assert_array_equal(tn.numpy(), jn, err_msg=f"{msg} n")


AZ, SCRIPT, RANDOM = TB.OPP_AZ, TB.OPP_SCRIPT, TB.OPP_RANDOM


@pytest.mark.parametrize("seats", [
    ((AZ, SCRIPT), 3), ((SCRIPT, AZ), 1), ((SCRIPT, SCRIPT), 0),
    ((AZ, RANDOM), 4), ((RANDOM, AZ), 5), ((SCRIPT, RANDOM), 6),
    ((RANDOM, SCRIPT), 7), ((RANDOM, RANDOM), 8)])
def test_script_steps_plain_match_jax(mixed, seats):
    """The plain multi-step function against JAX's steps iterated under
    the fast-forward's predicate (either seat the AlphaZero one, the other
    the ScriptPlayer or the RandomPlayer) and under a match's (two
    scripted or random seats, of one kind or both), on the draws of the
    fast-forward's key chain (``seats``: the seats' kinds and the chain's
    key): one block of 24, and the same 24 as a block of 7 that fills and
    is resumed by a block of 17.  Games stop inside the blocks, others run
    through them."""
    kinds, key = seats
    cfg = Config()
    mx = mixed
    b = mx.state.batch_size
    u, dice = _jax_chain_draws(jax.random.PRNGKey(key), 24, b)
    ref = _jax_steps(mx.state, mx.carry, mx.prev, u, dice, cfg, kinds)
    got = TB.agent_steps(mx.state, mx.carry, mx.prev, u, dice, cfg, kinds)
    _assert_equal(got, ref, "one block")
    n = got[3]
    assert bool((n == 24).any()) and bool(((n > 0) & (n < 24)).any())
    assert bool((n == 0).any())
    s1, c1, p1, n1 = TB.agent_steps(mx.state, mx.carry, mx.prev, u[:7],
                                    dice[:7], cfg, kinds)
    assert int(n1.max()) == 7
    s2, c2, p2, n2 = TB.agent_steps(s1, c1, p1, u[7:], dice[7:], cfg,
                                    kinds)
    _assert_equal((s2, c2, p2, n1 + n2), ref, "resumed")


@pytest.mark.parametrize("seats", [((SCRIPT, SCRIPT), 9),
                                   ((SCRIPT, RANDOM), 10)])
def test_agent_steps_plain_full_cards_match_jax(mixed, seats):
    """Under full cards: the plain multi-step function against JAX's steps
    iterated as in ``test_script_steps_plain_match_jax``, one block of 24
    from the mixed states, half of them with their card fields dealt by
    ``force_card_cases`` (large hands, piles empty or nearly so), the
    others with no card drawn yet: draws, reshuffles and full trades
    happen inside the block."""
    kinds, key = seats
    cfg = Config(simple_cards=False)
    mx = mixed
    b = mx.state.batch_size
    forced = TD.force_card_cases(mx.state, np.random.default_rng(key), cfg)
    half = torch.arange(b) % 2 == 0
    state = TS.tree_select(half, forced, mx.state)
    u, dice = _jax_chain_draws(jax.random.PRNGKey(key), 24, b)
    ref = _jax_steps(state, mx.carry, mx.prev, u, dice, cfg, kinds)
    got = TB.agent_steps(state, mx.carry, mx.prev, u, dice, cfg, kinds)
    _assert_equal(got, ref, "full cards")
    assert bool((got[0].card_sets_played > state.card_sets_played).any())
    assert bool((got[0].drawn_cards != state.drawn_cards).any())


def test_block_draws_put_back_what_was_not_used():
    """``BlockDraws``: a block holds the numbers of k per-step draws, and
    after ``rewind(m)`` the generator continues as if m draws were made."""
    gen = torch.Generator().manual_seed(3)
    u, dice = BlockDraws(gen, 5, "cpu").block(6)
    ref = torch.Generator().manual_seed(3)
    for j in range(6):
        ru, rd = draw_step_randoms(ref, 5, "cpu")
        assert torch.equal(u[j], ru) and torch.equal(dice[j], rd)
    for m in (0, 2, 6):
        gen = torch.Generator().manual_seed(3)
        draws = BlockDraws(gen, 5, "cpu")
        draws.block(6)
        draws.rewind(m)
        ref = torch.Generator().manual_seed(3)
        for _ in range(m):
            draw_step_randoms(ref, 5, "cpu")
        assert torch.equal(gen.get_state(), ref.get_state())


def _equal_fields(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def test_run_episodes_ff_block_sizes_agree(monkeypatch):
    """``run_episodes`` against the ScriptPlayer and against the
    RandomPlayer with the fast-forward in blocks of 1 (the per-iteration
    loop), 2, 5 and 64, of 2 doubling to 8 and of the default sizes:
    bit-equal states, carries, records and status, and the same generator
    state after the call.  Blocks of 1 launch once per iteration; larger
    blocks fewer times."""
    cfg = Config(mcts_simulations=2, max_depth=4)
    calls = []
    real = TB.agent_steps

    def counted(*a, **kw):
        calls.append(a[3].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(TB, "agent_steps", counted)
    for opponent in (TA.OPP_SCRIPT, TA.OPP_RANDOM):
        outs = {}
        for k, k_max in ((1, 1), (2, 2), (5, 5), (64, 64), (2, 8),
                         (TA.FF_BLOCK, TA.FF_BLOCK_MAX)):
            monkeypatch.setattr(TA, "FF_BLOCK", k)
            monkeypatch.setattr(TA, "FF_BLOCK_MAX", k_max)
            gen = torch.Generator().manual_seed(5)
            state = TD.mirrored_initial_states(4, generator=gen,
                                               device="cpu")
            draws = TA.GeneratorDraws(gen, cfg, 4, "cpu")
            calls.clear()
            out = TA.run_episodes(port_eval, state, draws, cfg, 24,
                                  opponent=opponent, az_seats=(True, False),
                                  sample_moves=False, record_all=False)
            outs[(k, k_max)] = (out, gen.get_state(), list(calls))
        base, g1, c1 = outs[(1, 1)]
        assert set(c1) == {1} and len(c1) > 24, opponent
        for k, (out, g, c) in outs.items():
            k = (opponent, k)
            assert _equal_fields(out.state, base.state), k
            assert _equal_fields(out.carry, base.carry), k
            assert all(torch.equal(x, y) for x, y in zip(out.samples,
                                                         base.samples)), k
            assert torch.equal(out.status, base.status), k
            assert torch.equal(out.prev_player, base.prev_player), k
            assert torch.equal(g, g1), k
            if k[1] != (1, 1):
                assert len(c) < len(c1), k


def _match_by_iteration(gen, state, agents, cfg, max_steps):
    """The per-iteration ``play_match`` loop the blocks replace: every
    iteration draws, both seats' agents step every game, and each game
    keeps its mover's state and carry; with the live micro-steps counted
    by the status check at the top of each iteration."""
    b = state.batch_size
    carry = TSA.init_carry(b, "cpu")
    prev = torch.full((b,), -1, dtype=torch.int32)
    t = live = 0

    def agent_step(kind, state, carry, reset, u, dice):
        if kind == TD.AGENT_SCRIPT:
            return TSA.script_step_recorded(state, carry, reset, u, dice,
                                            cfg)[:2]
        return TRA.random_step_recorded(state, u, dice, cfg)[0], carry

    while t < max_steps:
        alive = int((TR.game_status(state, cfg) == -1).sum())
        if not alive:
            break
        live += alive
        u, dice = draw_step_randoms(gen, b, "cpu")
        reset = state.cur_player != prev
        s0, c0 = agent_step(agents[0], state, carry, reset, u, dice)
        s1, c1 = (s0, c0) if agents[1] == agents[0] else agent_step(
            agents[1], state, carry, reset, u, dice)
        mover0 = state.cur_player == 0
        prev = state.cur_player
        state = TS.tree_select(mover0, s0, s1)
        carry = TS.tree_select(mover0, c0, c1)
        t += 1
    return state, t, live


SS, SR, RS, RR = ((TD.AGENT_SCRIPT, TD.AGENT_SCRIPT),
                  (TD.AGENT_SCRIPT, TD.AGENT_RANDOM),
                  (TD.AGENT_RANDOM, TD.AGENT_SCRIPT),
                  (TD.AGENT_RANDOM, TD.AGENT_RANDOM))


@pytest.mark.parametrize("max_steps,agents", [
    pytest.param(150, SS, id="150"), pytest.param(900, SS, id="900"),
    pytest.param(150, SR, id="150-script-random"),
    pytest.param(900, SR, id="900-script-random"),
    pytest.param(150, RS, id="150-random-script"),
    pytest.param(150, RR, id="150-random-random")])
def test_play_match_block_sizes_agree(mixed, monkeypatch, max_steps,
                                      agents):
    """``play_match`` with ScriptPlayer and RandomPlayer seats in blocks of
    1, 2, 5 and 64 and of the default size against the per-iteration
    loop it replaces, from the mixed states: equal status, rounds and
    steps, the generator in the same state after the match, and the live
    micro-steps (the sum of the blocks' step counts) equal to the
    per-iteration loop's count.  With 150 steps the step cap cuts a block
    short; with 900 every game ends inside a block."""
    cfg = Config()
    st = TS.tree_map(lambda x: x[::3].contiguous(), mixed.state)
    gen = torch.Generator().manual_seed(11)
    ref_state, ref_t, ref_live = _match_by_iteration(gen, st, agents, cfg,
                                                     max_steps)
    ref_gen = gen.get_state()
    if max_steps == 900:
        assert ref_t < 900 and bool((TR.game_status(ref_state, cfg)
                                     != -1).all())
    else:
        assert ref_t == 150
    live = []
    real = TB.agent_steps

    def counted(*a, **kw):
        out = real(*a, **kw)
        live.append(int(out[3].sum()))
        return out

    monkeypatch.setattr(TB, "agent_steps", counted)
    for k in (1, 2, 5, 64, TD.MATCH_BLOCK):
        monkeypatch.setattr(TD, "MATCH_BLOCK", k)
        live.clear()
        gen = torch.Generator().manual_seed(11)
        res = TD.play_match(gen, st, *agents, cfg, max_steps)
        assert res.steps == ref_t, k
        assert torch.equal(res.status, TR.game_status(ref_state, cfg)), k
        assert torch.equal(res.rounds, ref_state.round), k
        assert torch.equal(res.started_by, st.cur_player), k
        assert torch.equal(gen.get_state(), ref_gen), k
        assert sum(live) == ref_live, k
