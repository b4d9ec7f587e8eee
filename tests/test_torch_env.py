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


# The simple_cards=True configs of tests/test_parity.py, plus the
# lowest-index fortify tie-break.
RULE_CASES = [
    (0, Config()),
    (1, Config()),
    (4, Config(limit_attack_moves=True)),
    (5, Config(exact_fortify_tiebreak=False)),
]


@pytest.mark.parametrize("seed,cfg", RULE_CASES)
def test_rules_bit_exact(seed, cfg):
    """legal_actions, game_status, step and step_with_outcome agree on
    every field after every micro-step, with the same actions, dice and
    outcomes."""
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
        ta, to = torch.from_numpy(a), torch.from_numpy(o)
        assert_same_state(TR.step_with_outcome(ts, ta, to, cfg),
                          swo(js, jnp.asarray(a), jnp.asarray(o), jc),
                          f"step_with_outcome {t}")
        js = step(js, jnp.asarray(a), jnp.asarray(dice), jc)
        ts = TR.step(ts, ta, torch.from_numpy(dice), cfg)
        assert_same_state(ts, js, f"step {t}")
    assert phases == set(range(6)), phases


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
    st = TS.new_game(2, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    with pytest.raises(NotImplementedError):
        TR.step(st, torch.zeros(2, dtype=torch.int32),
                torch.ones((2, 5), dtype=torch.int32),
                Config(simple_cards=False))
