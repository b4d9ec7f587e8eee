"""Port parity of the scalar oracle, its agents and the native engine.

Three implementations of the rules in the port: the batched engine
(``env/rules.py``, its plain version on the CPU), the scalar oracle
(``env/oracle.py``) and the C++ engine (``native.py``).  Every comparison
here is exact:

- the port's oracle against JAX's, every field every step, on the same
  random legal actions, dice and card uniforms, in the five configurations
  of ``tests/test_parity.py``;
- the port's batched engine against the port's oracle (golden
  trajectories), the same way;
- the port's oracle agents against JAX's, and the port's batched plain
  agents against the port's oracle agents, on the same ``u`` and dice;
- the port's ``NativeEngine`` against the port's oracle, and its matches
  against JAX's binding for the same seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.agents import oracle_agents as JOA
from alphazero_risk_tpu.env import oracle as JO

from alphazero_risk_tpu_torch.agents import oracle_agents as TOA
from alphazero_risk_tpu_torch.agents import random_agent as TRA
from alphazero_risk_tpu_torch.agents import script_agent as TSA
from alphazero_risk_tpu_torch.config import Config, STATUS_NOT_ENDED
from alphazero_risk_tpu_torch.env import oracle as TO
from alphazero_risk_tpu_torch.env import rules
from alphazero_risk_tpu_torch.env.state import GameState, new_game

torch.set_num_threads(1)

# the five configurations of tests/test_parity.py
CONFIGS = [
    (0, Config()),
    (1, Config()),
    (2, Config(simple_cards=False)),
    (3, Config(simple_cards=False, limit_reinforcement_moves=False)),
    (4, Config(limit_attack_moves=True)),
]
BATCH = 4
STEPS = 700
ORACLE_FIELDS = [f.name for f in dataclasses.fields(TO.OracleState)]


def _jcfg(cfg):
    return jconfig.Config(**dataclasses.asdict(cfg))


def _fields(g):
    return {f: getattr(g, f) for f in ORACLE_FIELDS}


@pytest.mark.parametrize("seed,cfg", CONFIGS)
def test_oracle_matches_jax_oracle(seed, cfg):
    """Both oracles from the same deal through the same random legal
    actions, dice and card uniforms: every field equal after every step,
    and the same legal masks and statuses before it."""
    jc = _jcfg(cfg)
    rng = np.random.default_rng(seed)
    for game in range(2):
        perm = [int(x) for x in rng.permutation(42)]
        tg, jg = TO.new_game(perm), JO.new_game(perm)
        assert _fields(tg) == _fields(jg)
        for t in range(3000):
            status = TO.game_status(tg, cfg)
            assert status == JO.game_status(jg, jc), f"step {t}"
            if status != STATUS_NOT_ENDED:
                break
            mask = TO.legal_actions(tg, cfg)
            assert mask == JO.legal_actions(jg, jc), f"step {t}"
            a = int(rng.choice(np.nonzero(mask)[0]))
            dice = [int(d) for d in rng.integers(1, 7, 5)]
            u_card = float(rng.random())
            TO.step(tg, a, dice, cfg, u_card)
            JO.step(jg, a, dice, jc, u_card)
            assert _fields(tg) == _fields(jg), f"game {game} step {t}"
            if t % 25 == 0:
                # the helpers keep their names and agree too: the trade's
                # best combo, and the fortify reach and DFS order
                p = tg.cur_player
                if not cfg.simple_cards and p < 2:
                    assert TO._best_combo(tg, cfg) == \
                        JO._best_combo(jg, jc), f"step {t}"
                for src in range(42):
                    if tg.owner[src] == p:
                        assert TO._component(tg, p, src) == \
                            JO._component(jg, p, src)
                        assert TO._dfs_preorder(tg, p, src) == \
                            JO._dfs_preorder(jg, p, src)
        else:
            pytest.fail("oracle game did not terminate")


def oracle_to_state(games) -> GameState:
    def arr(name, dtype=torch.int32):
        return torch.tensor([getattr(g, name) for g in games], dtype=dtype)
    return GameState(
        owner=arr("owner"), army=arr("army"), phase=arr("phase"),
        round=arr("round"), cur_player=arr("cur_player"),
        reinforcements=arr("reinforcements"), cards=arr("cards"),
        card_sets_played=arr("card_sets_played"), mob_from=arr("mob_from"),
        mob_to=arr("mob_to"), can_draw_card=arr("can_draw_card", torch.bool),
        attacks_during_turn=arr("attacks_during_turn"),
        player_cards=arr("player_cards", torch.bool),
        drawn_cards=arr("drawn_cards", torch.bool))


def assert_state_equals_oracle(state, games, t):
    ref = oracle_to_state(games)
    for f in dataclasses.fields(GameState):
        a, b = getattr(state, f.name), getattr(ref, f.name)
        assert torch.equal(a, b), (
            f"step {t}: field {f.name} diverged:\n{a}\nvs oracle\n{b}")


def oracle_games(state):
    return [TO.OracleState(owner=[int(x) for x in state.owner[b]],
                           army=[1] * 42) for b in range(state.batch_size)]


@pytest.mark.parametrize("seed,cfg", CONFIGS)
def test_engine_follows_oracle(seed, cfg):
    """Golden trajectories: the port's batched engine (plain versions, on
    the CPU) and the port's oracle on the same random legal actions, dice
    and card uniforms; legal masks, statuses and every state field equal
    at every step, until every game has ended."""
    rng = np.random.default_rng(seed)
    state = new_game(BATCH, generator=torch.Generator().manual_seed(seed),
                     device="cpu")
    games = oracle_games(state)
    assert_state_equals_oracle(state, games, -1)
    for t in range(STEPS):
        mask = rules.legal_actions(state, cfg)
        statuses = [TO.game_status(g, cfg) for g in games]
        assert rules.game_status(state, cfg).tolist() == statuses, \
            f"status diverged at {t}"
        actions = np.zeros(BATCH, np.int32)
        for b, g in enumerate(games):
            om = TO.legal_actions(g, cfg)
            if statuses[b] == STATUS_NOT_ENDED:
                assert mask[b].tolist() == om, f"step {t} game {b}"
            actions[b] = rng.choice(np.nonzero(om)[0])
        dice = rng.integers(1, 7, size=(BATCH, 5)).astype(np.int32)
        u_card = rng.random(BATCH).astype(np.float32)
        state = rules.step(state, torch.from_numpy(actions),
                           torch.from_numpy(dice), cfg,
                           None if cfg.simple_cards
                           else torch.from_numpy(u_card))
        for b, g in enumerate(games):
            TO.step(g, int(actions[b]), [int(d) for d in dice[b]], cfg,
                    float(u_card[b]))
        assert_state_equals_oracle(state, games, t)
        if all(s != STATUS_NOT_ENDED for s in statuses):
            break
    else:
        pytest.fail("games did not terminate within the step budget")


AGENT_FIELDS = ("owner", "army", "phase", "round", "cur_player",
                "reinforcements", "cards", "card_sets_played", "mob_from",
                "mob_to")


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 3),
                                       ("script", 1), ("script", 4)])
def test_oracle_agents_match_jax_and_batched_agents(kind, seed):
    """Per step, one ``u`` [B, 4] and dice [B, 5]: the port's batched
    plain agent (``random_step_recorded`` / ``script_step_recorded`` with
    its carry and the reset on a change of mover), the port's oracle agent
    and JAX's oracle agent (with their carries) leave equal games, and the
    two oracle agents' carries are equal."""
    cfg = Config()
    jc = _jcfg(cfg)
    rng = np.random.default_rng(seed)
    state = new_game(BATCH, generator=torch.Generator().manual_seed(seed),
                     device="cpu")
    tgames, jgames = oracle_games(state), oracle_games(state)
    jgames = [JO.OracleState(owner=list(g.owner), army=list(g.army))
              for g in jgames]
    carry = TSA.init_carry(BATCH, "cpu")
    tcar = [TOA.OracleScriptCarry() for _ in range(BATCH)]
    jcar = [JOA.OracleScriptCarry() for _ in range(BATCH)]
    prev = np.full(BATCH, -1, np.int32)
    for t in range(900):
        if all(TO.game_status(g, cfg) != STATUS_NOT_ENDED for g in tgames):
            break
        u = rng.random((BATCH, 4)).astype(np.float32)
        dice = rng.integers(1, 7, (BATCH, 5)).astype(np.int32)
        ut, dt = torch.from_numpy(u), torch.from_numpy(dice)
        if kind == "random":
            state, _ = TRA.random_step_recorded(state, ut, dt, cfg)
            for b in range(BATCH):
                TOA.random_step(tgames[b], list(u[b]),
                                [int(d) for d in dice[b]], cfg)
                JOA.random_step(jgames[b], list(u[b]),
                                [int(d) for d in dice[b]], jc)
        else:
            reset = np.array([g.cur_player for g in tgames]) != prev
            state, carry, _ = TSA.script_step_recorded(
                state, carry, torch.from_numpy(reset), ut, dt, cfg)
            for b in range(BATCH):
                args = (list(u[b]), [int(d) for d in dice[b]])
                tcar[b] = TOA.script_step(tgames[b], tcar[b],
                                          bool(reset[b]), *args, cfg)
                jcar[b] = JOA.script_step(jgames[b], jcar[b],
                                          bool(reset[b]), *args, jc)
                assert dataclasses.asdict(tcar[b]) == \
                    dataclasses.asdict(jcar[b]), f"step {t} carry {b}"
            prev = np.array([g.cur_player for g in tgames])
        for b in range(BATCH):
            assert _fields(tgames[b]) == _fields(jgames[b]), f"step {t}"
        for name in AGENT_FIELDS:
            want = torch.tensor([getattr(g, name) for g in tgames],
                                dtype=torch.int32)
            assert torch.equal(getattr(state, name), want), \
                f"step {t}: {name} diverged"
    else:
        pytest.fail("games did not finish in the step budget")


# ---------------------------------------------------------------- native

@pytest.fixture(scope="module")
def engine():
    from alphazero_risk_tpu_torch.native import NativeEngine
    return NativeEngine(Config())


def c_state_fields(s):
    return dict(owner=list(s.owner), army=list(s.army), phase=s.phase,
                round=s.round, cur_player=s.cur_player,
                reinforcements=s.reinforcements, cards=list(s.cards),
                card_sets_played=s.card_sets_played, mob_from=s.mob_from,
                mob_to=s.mob_to, can_draw_card=bool(s.can_draw_card),
                attacks_during_turn=s.attacks_during_turn)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_engine_follows_oracle(engine, seed):
    """The port's binding and the port's oracle on the same random legal
    actions and dice: statuses, legal masks and every field the C state
    holds equal at every step, to the end of the game."""
    cfg = Config()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(42).astype(np.int32)
    cs = engine.new_game(perm)
    og = TO.new_game([int(x) for x in perm])
    for t in range(1500):
        status = TO.game_status(og, cfg)
        assert engine.status(cs) == status
        if status != STATUS_NOT_ENDED:
            break
        mask = np.array(TO.legal_actions(og, cfg))
        assert (engine.legal_actions(cs) == mask).all(), f"step {t}"
        action = int(rng.choice(np.nonzero(mask)[0]))
        dice = rng.integers(1, 7, 5).astype(np.int32)
        engine.step(cs, action, dice)
        TO.step(og, action, [int(d) for d in dice], cfg)
        got, want = c_state_fields(cs), _fields(og)
        for k, v in got.items():
            assert v == want[k], f"step {t}: field {k}: {v} != {want[k]}"
    else:
        pytest.fail("game did not terminate")


def test_native_matches_jax_binding(engine):
    """``play_games`` through the port's binding and JAX's, for the same
    agents and seeds: statuses, rounds and micro-steps equal (one
    library, two bindings); the structs have one layout."""
    import ctypes

    from alphazero_risk_tpu import native as JN
    from alphazero_risk_tpu_torch import native as TN

    assert engine.lib.risk_state_size() == ctypes.sizeof(TN.CRiskState) \
        == ctypes.sizeof(JN.CRiskState)
    assert TN.CRiskState._fields_ == JN.CRiskState._fields_
    assert TN.CRiskConfig._fields_ == JN.CRiskConfig._fields_
    jeng = JN.NativeEngine(jconfig.Config())
    for a0, a1, n, seed in (("sp", "rp", 64, 11), ("sp", "sp", 64, 12),
                            ("rp", "sp", 32, 13), ("rp", "rp", 32, 14)):
        got = engine.play_games(a0, a1, n, seed)
        want = jeng.play_games(a0, a1, n, seed)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] > 0
        assert (got[0] != STATUS_NOT_ENDED).all()
    res, _, _ = engine.play_games("sp", "rp", 64, 11)
    assert (res == 0).sum() >= 56       # the script crushes random play
    assert TN.available()
