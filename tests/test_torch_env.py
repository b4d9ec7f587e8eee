"""Port parity: board tables, game state, rules and featurization.

The PyTorch port (``alphazero_risk_tpu_torch``) against the JAX package on
identical inputs, on the CPU.  Actions and dice come from numpy with a
seed; every field of the state must be bit-identical after every
micro-step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.env.featurize import featurize as jax_featurize
from alphazero_risk_tpu.env import rules as JR
from alphazero_risk_tpu.env import state as JS
from alphazero_risk_tpu.env import topology as JT
from alphazero_risk_tpu.mcts.outcomes import OUTCOME_PROBS as J_OUTCOMES

from alphazero_risk_tpu_torch import config as tconfig
from alphazero_risk_tpu_torch.agents.driver import mirrored_initial_states
from alphazero_risk_tpu_torch.env import rules as TR
from alphazero_risk_tpu_torch.env import state as TS
from alphazero_risk_tpu_torch.env import topology as TT
from alphazero_risk_tpu_torch.env.featurize import featurize
from alphazero_risk_tpu_torch.mcts.outcomes import OUTCOME_PROBS

Config = tconfig.Config
# small tensors: intra-op threads only add overhead
torch.set_num_threads(1)


def jcfg(cfg):
    return jconfig.Config(**dataclasses.asdict(cfg))


def to_port(js) -> TS.GameState:
    return TS.GameState(**{
        f.name: torch.from_numpy(np.array(getattr(js, f.name)))
        for f in dataclasses.fields(TS.GameState)})


def assert_same_state(ts, js, where=""):
    for f in dataclasses.fields(TS.GameState):
        a = getattr(ts, f.name).numpy()
        b = np.asarray(getattr(js, f.name))
        assert a.dtype == b.dtype, (where, f.name, a.dtype, b.dtype)
        assert (a == b).all(), f"{where}: field {f.name} differs\n{a}\n{b}"


TABLES = ["ADJACENCY", "ADJ_F32", "NEIGHBOR_RANK", "NEIGHBOR_IDX",
          "CONTINENT_MASK", "CONTINENT_BONUS", "CONTINENT_SIZE",
          "SCRIPT_LAND_RANK", "CONTINENT_TIE_RANK", "CARD_INFANTRY",
          "CARD_HORSE", "CARD_SIEGE"]


@pytest.mark.parametrize("name", TABLES)
def test_topology_tables_equal(name):
    a, b = getattr(TT, name), getattr(JT, name)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_outcome_table_and_constants_equal():
    np.testing.assert_array_equal(OUTCOME_PROBS, J_OUTCOMES)
    np.testing.assert_array_equal(TR.CARD_SET_GAIN, np.asarray(JR._GAIN))
    names = [n for n in dir(jconfig) if n.isupper() and n != "DEFAULT_CONFIG"]
    assert names and all(getattr(tconfig, n) == getattr(jconfig, n)
                         for n in names)
    assert dataclasses.asdict(Config()) == dataclasses.asdict(
        jconfig.Config())


def test_new_game_invert_and_mirror_match():
    key = jax.random.PRNGKey(3)
    b = 6
    js = JS.new_game(key, b)
    perm = jax.vmap(lambda k: jax.random.permutation(k, 42))(
        jax.random.split(key, b))
    ts = TS.new_game(b, perm=torch.from_numpy(np.array(perm)),
                     device="cpu")
    assert_same_state(ts, js, "new_game")
    assert_same_state(TS.invert_players(ts), JS.invert_players(js),
                      "invert_players")
    assert_same_state(TS.set_current_player(ts, 1),
                      JS.set_current_player(js, 1), "set_current_player")

    from alphazero_risk_tpu.agents.driver import (
        mirrored_initial_states as j_mirrored)
    jm = j_mirrored(key, 2 * b)
    tm = mirrored_initial_states(2 * b, perm=torch.from_numpy(
        np.array(perm)), device="cpu")
    assert_same_state(tm, jm, "mirrored_initial_states")


FULL_CARDS = Config(simple_cards=False)

# The configs of tests/test_parity.py (seeds 2 and 3: full cards), plus
# the lowest-index fortify tie-break.
RULE_CASES = [
    (0, Config()),
    (1, Config()),
    (4, Config(limit_attack_moves=True)),
    (5, Config(exact_fortify_tiebreak=False)),
    pytest.param(2, FULL_CARDS, id="2-full-cards"),
    pytest.param(3, FULL_CARDS.replace(limit_reinforcement_moves=False),
                 id="3-full-cards-free-reinforcement"),
]


@pytest.mark.parametrize("seed,cfg", RULE_CASES)
def test_rules_bit_exact(seed, cfg):
    """legal_actions, game_status, step and step_with_outcome agree on
    every field after every micro-step, with the same actions, dice,
    outcomes and (full cards) card uniforms.  Under full cards
    step_with_outcome has no card uniform and raises in both packages
    (``test_step_with_outcome_refuses_full_cards``); at least one full
    trade happens."""
    b, steps = 6, 200
    rng = np.random.default_rng(seed)
    jc = jcfg(cfg)
    js = JS.new_game(jax.random.PRNGKey(seed), b)
    ts = to_port(js)
    step = jax.jit(JR.step, static_argnums=3)
    swo = jax.jit(JR.step_with_outcome, static_argnums=3)
    legal = jax.jit(JR.legal_actions, static_argnums=1)
    status = jax.jit(JR.game_status, static_argnums=1)
    phases = set()
    for t in range(steps):
        jm = np.asarray(legal(js, jc))
        np.testing.assert_array_equal(TR.legal_actions(ts, cfg).numpy(), jm)
        st = np.asarray(status(js, jc))
        np.testing.assert_array_equal(TR.game_status(ts, cfg).numpy(), st)
        phases.update(np.asarray(js.phase).tolist())
        a = np.array([rng.choice(np.nonzero(m)[0]) for m in jm], np.int32)
        dice = rng.integers(1, 7, (b, 5)).astype(np.int32)
        o = rng.integers(0, 3, b).astype(np.int32)
        u_card = rng.random(b).astype(np.float32)
        ta, to = torch.from_numpy(a), torch.from_numpy(o)
        if cfg.simple_cards:
            assert_same_state(TR.step_with_outcome(ts, ta, to, cfg),
                              swo(js, jnp.asarray(a), jnp.asarray(o), jc),
                              f"step_with_outcome {t}")
            js = step(js, jnp.asarray(a), jnp.asarray(dice), jc)
        else:
            js = step(js, jnp.asarray(a), jnp.asarray(dice), jc,
                      jnp.asarray(u_card))
        ts = TR.step(ts, ta, torch.from_numpy(dice), cfg,
                     torch.from_numpy(u_card))
        assert_same_state(ts, js, f"step {t}")
    assert phases == set(range(6)), phases
    if not cfg.simple_cards:
        assert (ts.card_sets_played > 0).any()


def test_graph_walks_match():
    """connected_to, component_labels and dfs_preorder_rank (the three
    fixpoint loops of the JAX engine) on random ownership masks."""
    rng = np.random.default_rng(11)
    owned = rng.random((64, 42)) < 0.55
    src = rng.integers(0, 42, 64).astype(np.int32)
    jo, js_ = jnp.asarray(owned), jnp.asarray(src)
    to, ts_ = torch.from_numpy(owned), torch.from_numpy(src)
    np.testing.assert_array_equal(TR.connected_to(to, ts_).numpy(),
                                  np.asarray(JR.connected_to(jo, js_)))
    np.testing.assert_array_equal(TR.component_labels(to).numpy(),
                                  np.asarray(JR.component_labels(jo)))
    np.testing.assert_array_equal(TR.dfs_preorder_rank(to, ts_).numpy(),
                                  np.asarray(JR.dfs_preorder_rank(jo, js_)))


@pytest.fixture(scope="module")
def played_states():
    """Snapshots of port games under random legal play (all phases)."""
    cfg = Config()
    gen = torch.Generator().manual_seed(0)
    st = TS.new_game(16, generator=gen, device="cpu")
    snaps = []
    for t in range(240):
        legal = TR.legal_actions(st, cfg)
        a = torch.argmax(torch.where(legal, torch.rand(legal.shape,
                                                       generator=gen), -1.0),
                         -1).to(torch.int32)
        st = TR.step_key(st, a, gen, cfg)
        if t % 20 == 0:
            snaps.append(st)
    return TS.tree_map(lambda *xs: torch.cat(xs), *snaps)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_featurize_exact(played_states, version):
    cfg = Config(feature_version=version)
    js = JS.GameState(**{f.name: jnp.asarray(getattr(played_states,
                                                     f.name).numpy())
                         for f in dataclasses.fields(TS.GameState)})
    ref = np.asarray(jax_featurize(js, jcfg(cfg)))
    out = featurize(played_states, cfg).numpy()
    assert out.shape == ref.shape == (played_states.batch_size, 7, 6,
                                      cfg.num_features)
    np.testing.assert_array_equal(out, ref)


def test_full_cards_not_ported():
    """Full cards are ported: ``step_key`` (its dice, then its card
    uniforms, from the generator) played by random legal moves, and
    ``step`` fed those draws against the JAX ``step``, every field after
    every micro-step, through draws and trades."""
    cfg, b, steps = FULL_CARDS, 4, 160
    gen = torch.Generator().manual_seed(4)
    js = JS.new_game(jax.random.PRNGKey(8), b)
    ts = to_port(js)
    step = jax.jit(JR.step, static_argnums=3)
    for t in range(steps):
        legal = TR.legal_actions(ts, cfg)
        a = torch.argmax(torch.where(legal, torch.rand(legal.shape,
                                                       generator=gen), -1.0),
                         -1).to(torch.int32)
        state = gen.get_state()
        dice = TR.roll_dice(gen, b)
        u_card = torch.rand((b,), generator=gen)
        gen.set_state(state)
        ts = TR.step_key(ts, a, gen, cfg)
        js = step(js, jnp.asarray(a.numpy()), jnp.asarray(dice.numpy()),
                  jcfg(cfg), jnp.asarray(u_card.numpy()))
        assert_same_state(ts, js, f"step_key {t}")
    assert (ts.card_sets_played > 0).any() and ts.drawn_cards.any()


def test_step_with_outcome_refuses_full_cards():
    """Neither package has a card uniform for ``step_with_outcome``: the
    JAX trace asserts, the port raises with its message before any
    launch, and so does a full-cards ``step`` without ``u_card``."""
    js = JS.new_game(jax.random.PRNGKey(0), 2)
    ts = to_port(js)
    a, o = np.zeros(2, np.int32), np.zeros(2, np.int32)
    with pytest.raises(AssertionError, match=TR.NEEDS_UNIFORM):
        jax.jit(JR.step_with_outcome, static_argnums=3)(
            js, jnp.asarray(a), jnp.asarray(o), jcfg(FULL_CARDS))
    for fn in (lambda: TR.step_with_outcome(ts, torch.from_numpy(a),
                                            torch.from_numpy(o), FULL_CARDS),
               lambda: TR.step(ts, torch.from_numpy(a),
                               torch.ones((2, 5), dtype=torch.int32),
                               FULL_CARDS)):
        with pytest.raises(ValueError, match=TR.NEEDS_UNIFORM):
            fn()


def _card_case_states(seed, b=256):
    """``b`` states with random owners, armies and movers, their card
    fields dealt by ``driver.force_card_cases`` from a numpy seed; the
    port's and the JAX package's copies."""
    from alphazero_risk_tpu_torch.agents.driver import force_card_cases
    rng = np.random.default_rng(seed)
    ts = to_port(JS.new_game(jax.random.PRNGKey(seed), b))
    ts = ts.replace(
        owner=torch.from_numpy(rng.integers(0, 3, (b, 42)).astype(np.int32)),
        army=torch.from_numpy(rng.integers(1, FULL_CARDS.land_army_max + 1,
                                           (b, 42)).astype(np.int32)),
        cur_player=torch.from_numpy(rng.integers(0, 2, b).astype(np.int32)),
        card_sets_played=torch.from_numpy(
            rng.integers(0, 70, b).astype(np.int32)))
    ts = force_card_cases(ts, rng, FULL_CARDS)
    js = JS.GameState(**{f.name: jnp.asarray(getattr(ts, f.name).numpy())
                         for f in dataclasses.fields(TS.GameState)})
    return ts, js, rng


def _combo_scores(hand, owned):
    """[B, 4] numpy: each combo kind's owned count, -1 where invalid."""
    types = np.stack([JT.CARD_INFANTRY, JT.CARD_HORSE, JT.CARD_SIEGE])
    ht = hand[:, None, :] & types[None]
    same = np.where(ht.sum(-1) >= 3,
                    np.minimum((ht & owned[:, None]).sum(-1), 3), -1)
    each = np.where(ht.any(-1).all(-1),
                    (ht & owned[:, None]).any(-1).sum(-1), -1)
    return np.concatenate([same, each[:, None]], axis=1)


def test_full_cards_crafted_states():
    """``draw_card``, ``_best_combo``, ``play_cards`` and ``end_turn``
    under full cards on 256 crafted states (hands of 0-12 cards, piles
    empty, nearly empty or full, bonus lands at land_army_max - 1 and
    - 2), against the JAX package; the states cover every combo kind
    winning, ties between kinds, three cards (no trade), four or more
    with no combo, the reshuffle and a draw skipped on an empty pile."""
    ts, js, rng = _card_case_states(17)
    jc = jcfg(FULL_CARDS)
    b = ts.batch_size
    u = rng.random(b).astype(np.float32)
    u[:16] = np.nextafter(np.float32(1), np.float32(0))
    u[16:32] = 0.0
    tu, ju = torch.from_numpy(u), jnp.asarray(u)
    assert_same_state(TR.draw_card(ts, FULL_CARDS, tu),
                      jax.jit(JR.draw_card, static_argnums=1)(js, jc, ju),
                      "draw_card")
    assert_same_state(TR.end_turn(ts, FULL_CARDS, tu),
                      jax.jit(JR.end_turn, static_argnums=1)(js, jc, ju),
                      "end_turn")
    j_played = jax.jit(JR.play_cards, static_argnums=1)(js, jc)
    assert_same_state(TR.play_cards(ts, FULL_CARDS), j_played, "play_cards")
    rows = np.arange(b)
    cur = np.asarray(js.cur_player)
    hand = np.asarray(js.player_cards)[rows, cur]
    owned = np.asarray(js.owner) == cur[:, None]
    combo, valid = jax.jit(JR._best_combo)(jnp.asarray(hand),
                                           jnp.asarray(owned))
    tcombo, tvalid = TR._best_combo(torch.from_numpy(hand),
                                    torch.from_numpy(owned))
    np.testing.assert_array_equal(tcombo.numpy(), np.asarray(combo))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))

    # what the states cover
    n = hand.sum(-1)
    scores = _combo_scores(hand, owned)
    valid = np.asarray(valid)
    kinds = set(np.argmax(scores * 8 + (3 - np.arange(4)), -1)[valid])
    top = scores.max(-1)
    assert kinds == {0, 1, 2, 3}, kinds
    assert (valid & ((scores == top[:, None]).sum(-1) >= 2)).sum() >= 4
    assert ((n == 3) & (scores.max(-1) >= 0)).any()
    assert (~valid[n == 3]).all()
    assert ((n >= 4) & (top < 0)).any()
    empty = np.asarray(js.drawn_cards).all(-1)
    can = np.asarray(js.can_draw_card)
    assert (empty & can).sum() >= 8 and (empty & ~can).sum() >= 4
    assert ((np.asarray(js.drawn_cards).sum(-1) >= 40) & ~empty).any()
    army = np.asarray(js.army)
    first_owned = np.asarray(combo) & owned
    assert (valid & (first_owned & (army == FULL_CARDS.land_army_max - 1)
                     ).any(-1)).any()
    bonus = np.asarray(j_played.army) != army
    assert bonus.any(-1).sum() >= 8
