"""Port parity: tree reuse across moves and the game invariants.

``reroot`` in both packages on trees grown from the same injected Gumbel
noise (the harness of ``test_torch_mcts.py``), every array bit-equal;
``search_with_reuse`` from the rerooted trees with root noise on and off,
with one game's carried root stale in a single field and one game not
reused; ``run_episodes`` under ``tree_reuse`` with every draw injected (the
harness of ``test_torch_slice.py``): self-play, versus with records and the
versus fast-forward in two chunks, states and records bit-equal and the
port's ``validate`` passing on the final states; ``validate`` against
JAX's on valid and corrupted states.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.agents import script_agent as JSA
from alphazero_risk_tpu.agents.driver import mirrored_initial_states
from alphazero_risk_tpu.env import checks as JC
from alphazero_risk_tpu.mcts import search as JM
from alphazero_risk_tpu.training import actor as JA

from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env import checks as TC
from alphazero_risk_tpu_torch.env import rules as TRL
from alphazero_risk_tpu_torch.env import state as TS
from alphazero_risk_tpu_torch.mcts import search as TM
from alphazero_risk_tpu_torch.training import actor as TA

from test_torch_mcts import (jax_eval, played_roots, port_eval,
                             search_gumbel, to_jax)
from test_torch_slice import (JaxChainDraws, _assert_carry_equal,
                              _assert_states_equal, _port_state)

torch.set_num_threads(1)
B = 12


@pytest.fixture(autouse=True)
def _concrete_gamma_table():
    """JAX's root noise caches its Gamma table with ``lru_cache``: built
    first inside a trace, the cache would hold that trace's tracers for the
    next one.  Build it eagerly before each test."""
    JM._gamma_log_quantiles.cache_clear()
    JM._gamma_log_quantiles(0.3)


def _configs(**kw):
    cfg = Config(max_depth=12, tree_reuse=True, **kw)
    return cfg, jconfig.Config(**dataclasses.asdict(cfg))


def assert_trees_equal(tt, jt, msg=""):
    """Every array of a port tree bit-equal (value and dtype) to a JAX
    tree's."""
    for f in dataclasses.fields(TM.Tree):
        if f.name == "states":
            _assert_states_equal(tt.states, jt.states, f"{msg} states")
            continue
        t, j = getattr(tt, f.name).numpy(), np.asarray(getattr(jt, f.name))
        assert t.dtype == j.dtype, (msg, f.name, t.dtype, j.dtype)
        np.testing.assert_array_equal(t, j, err_msg=f"{msg} {f.name}")


@functools.lru_cache(maxsize=None)
def _jax_search(jc):
    return jax.jit(lambda r, k: JM.search(r, k, jc, jax_eval))


def grown_trees(cfg, jc, root, seed=7):
    key = jax.random.PRNGKey(seed)
    jres = _jax_search(jc)(to_jax(root), key)
    tres = TM.search(root, search_gumbel(key, cfg.mcts_simulations,
                                         cfg.max_depth, root.batch_size),
                     cfg, port_eval)
    assert_trees_equal(tres.tree, jres.tree, "grown")
    return tres, jres


def _edges(tree, prefer):
    """(action, outcome) per game: the first legal root edge for which
    ``prefer(game, child, outcome)`` holds, else the root's most visited
    edge with its first expanded outcome."""
    ch, visit = tree.children.numpy(), tree.visit.numpy()
    legal = tree.legal.numpy()
    acts, outs = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for i in range(B):
        r = int(tree.root[i])
        a = int(visit[i, r].argmax())
        acts[i], outs[i] = a, int(np.argmax(ch[i, r, a] >= 0))
        for a, o in np.argwhere(legal[i, r][:, None].repeat(3, 1)):
            if prefer(i, int(ch[i, r, a, o]), int(o)):
                acts[i], outs[i] = a, o
                break
    return acts, outs


CASES = {
    # a played edge with no expanded child: nothing is reused
    "no_child": dict(nodes=0, prefer=lambda t, i, c, o: c < 0),
    # a battle edge whose outcome is not 0, with its subtree
    "battle_outcome": dict(nodes=0,
                           prefer=lambda t, i, c, o: c >= 0 and o > 0),
    # a child that ended the game (roots at the round cap)
    "terminal_child": dict(
        nodes=0, at_cap=True,
        prefer=lambda t, i, c, o: c >= 0 and bool(t.terminal[i, c])),
    # a tree filled to its node budget (the last node rewritten)
    "full_tree": dict(nodes=7, prefer=lambda t, i, c, o: c >= 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reroot_matches_jax(case):
    spec = CASES[case]
    cfg, jc = _configs(mcts_simulations=8, max_nodes=spec["nodes"])
    assert cfg.num_nodes == (spec["nodes"] or 2 * 8 + 2)
    root = played_roots(B, 90, seed=3)
    if spec.get("at_cap"):
        root = root.replace(round=torch.full_like(root.round,
                                                  cfg.max_game_rounds))
    tres, jres = grown_trees(cfg, jc, root)
    tree = tres.tree
    acts, outs = _edges(tree, lambda i, c, o: spec["prefer"](tree, i, c, o))
    jt, jr = jax.jit(lambda t, a, o: JM.reroot(t, a, o, jc))(
        jres.tree, jnp.asarray(acts), jnp.asarray(outs))
    tt, tr = TM.reroot(tree, torch.from_numpy(acts), torch.from_numpy(outs),
                       cfg)
    assert_trees_equal(tt, jt, case)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # fresh contiguous arrays, no kernel pointer pack carried over
    assert "_k6" not in tt.__dict__
    assert all(getattr(tt, f.name).is_contiguous()
               for f in dataclasses.fields(TM.Tree) if f.name != "states")
    reused, nf = tr.numpy(), tt.next_free.numpy()
    if case == "no_child":
        assert not reused.any() and (nf == 0).all()
    elif case == "battle_outcome":
        assert reused.all() and (outs > 0).any() and (nf > 1).any()
    elif case == "terminal_child":
        rows = np.arange(B)
        assert tt.terminal.numpy()[rows, tt.root.numpy()][reused].any()
    else:
        assert (tree.next_free.numpy() >= cfg.num_nodes - 1).all()
        assert reused.all() and (nf > 1).any()
    # the carried root is the played child's state, with no parent
    for i in np.nonzero(reused)[0]:
        c = int(tree.children[i, tree.root[i], acts[i], outs[i]])
        assert int(tt.parent[i, tt.root[i]]) == -1
        assert torch.equal(tt.states.army[i, tt.root[i]],
                           tree.states.army[i, c])
    assert (tt.root[~tr] == 0).all()
    assert (tt.root[tr] < tt.next_free[tr]).all()


@pytest.mark.parametrize("noise", [False, True])
def test_search_with_reuse_matches_jax(noise):
    """The rerooted trees searched again: one game's carried root stale in
    ``reinforcements`` only, one game whose edge had no child; the others
    continue their subtrees."""
    cfg, jc = _configs(mcts_simulations=8, use_dirichlet_noise=noise)
    root = played_roots(B, 90, seed=5)
    base, jbase = cfg.replace(use_dirichlet_noise=False), \
        jc.replace(use_dirichlet_noise=False)
    tres, jres = grown_trees(base, jbase, root)
    tree = tres.tree
    acts, outs = _edges(tree, lambda i, c, o: (c < 0) == (i == 1))
    tt, tr = TM.reroot(tree, torch.from_numpy(acts), torch.from_numpy(outs),
                       cfg)
    jt, jr = JM.reroot(jres.tree, jnp.asarray(acts), jnp.asarray(outs), jc)
    assert not bool(tr[1]) and bool(tr.sum() >= B - 1)
    # the next roots: the played edges' children (as the search expanded
    # them where it did), game 0 stale in one field only
    nxt = TRL.step_with_outcome(root, torch.from_numpy(acts),
                                torch.from_numpy(outs), cfg)
    nxt.reinforcements[0] += 1
    key = jax.random.PRNGKey(13)
    jout = jax.jit(lambda r, k, t, u: JM.search_with_reuse(
        r, k, jc, jax_eval, t, u))(to_jax(nxt), key, jt, jr)
    k_sims = key
    noise_u = None
    if noise:
        k_sims, k_noise = jax.random.split(key)
        noise_u = torch.from_numpy(np.array(jax.random.uniform(
            k_noise, (B, 43), jnp.float32, minval=1e-7, maxval=1.0 - 1e-4)))
    tout = TM.search_with_reuse(nxt, search_gumbel(k_sims, 8, 12, B), cfg,
                                port_eval, tt, tr, noise_u=noise_u)
    same = TM.carried_roots_match(tt, nxt) & tr
    assert not bool(same[0]) and not bool(same[1]) and bool(same[2:].any())
    got, want = tout.tree, jout.tree
    for name in ("visit", "children", "next_free", "root", "expanded",
                 "parent", "terminal"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("prior", "wsum", "value"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-5 if noise else 1e-6, atol=1e-9 if noise else 0,
            err_msg=name)
    np.testing.assert_array_equal(tout.visit_counts.numpy(),
                                  np.asarray(jout.visit_counts))
    # the carried games kept their earlier visits under the new root (a
    # child expanded as a leaf had none)
    carried, total = same.numpy(), tout.visit_counts.sum(-1).numpy()
    assert (total[carried] >= 8).all() and (total[carried] > 8).any()
    assert (total[~carried] == 8).all()


REUSE_MODES = {
    "selfplay_noise": dict(cfg=dict(use_dirichlet_noise=True),
                           kw=dict(sample_moves=True), steps=40, chunks=1),
    "versus_script_record_all": dict(
        cfg={}, kw=dict(opponent=1, az_seats=(True, False),
                        sample_moves=False, record_all=True),
        steps=40, chunks=1),
    "versus_random_fast_forward": dict(
        cfg={}, kw=dict(opponent=2, az_seats=(True, False),
                        sample_moves=False, record_all=False),
        steps=20, chunks=2),
}


@pytest.mark.parametrize("mode", sorted(REUSE_MODES))
def test_run_episodes_with_reuse_matches_jax(mode):
    """States, opponent carry, records and the AlphaZero decision count
    bit-equal to JAX's ``run_episodes`` under ``tree_reuse`` (the move's
    dice split as ``step_key`` splits them, so the draws are those of the
    path without reuse); each chunk starts with no carried tree."""
    spec = REUSE_MODES[mode]
    cfg = Config(mcts_simulations=4, max_depth=8, tree_reuse=True,
                 **spec["cfg"])
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    b, steps = 4, spec["steps"]
    ff = not spec["kw"].get("record_all", True)
    js = mirrored_initial_states(jax.random.PRNGKey(5), b)
    ts = _port_state(js)
    run = jax.jit(lambda s, k, c, p: JA.run_episodes(
        jax_eval, s, k, jc, steps, carry_in=c, prev_in=p, **spec["kw"]))
    jcar, jprev = JSA.init_carry(b), jnp.full((b,), -1, jnp.int32)
    tcar = tprev = None
    for c, key in enumerate(jax.random.split(jax.random.PRNGKey(11),
                                             spec["chunks"])):
        jout = run(js, key, jcar, jprev)
        tout = TA.run_episodes(port_eval, ts,
                               JaxChainDraws(key, cfg, b, fast_forward=ff),
                               cfg, steps, carry_in=tcar, prev_in=tprev,
                               **spec["kw"])
        js, jcar, jprev = jout.state, jout.carry, jout.prev_player
        ts, tcar, tprev = tout.state, tout.carry, tout.prev_player
        msg = f"{mode} chunk {c}"
        _assert_states_equal(ts, js, msg)
        _assert_carry_equal(tcar, jcar, msg)
        np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
        for name in TA.SampleBatch._fields:
            np.testing.assert_array_equal(
                getattr(tout.samples, name).numpy(),
                np.asarray(getattr(jout.samples, name)),
                err_msg=f"{msg} samples.{name}")
        valid = np.asarray(jout.samples.valid)
        az = valid & (np.asarray(jout.samples.cur_player) == 0) \
            if spec["kw"].get("az_seats") else valid
        assert int(tout.az_decisions) == int(az.sum()) > 0
    TC.validate(ts, cfg)
    JC.validate(js, jc)
    assert (ts.round > 1).all()


def _corrupt(st, what):
    st = TS.tree_map(torch.clone, st)
    if what == "owner_range":
        st.owner[0, 3] = 3
    elif what == "army_max":
        st.army[1, 0] = 100
    elif what == "empty_land":
        st.army[2, 5] = 0
    elif what == "negative_reinforcements":
        st.reinforcements[0] = -1
    elif what == "negative_cards":
        st.cards[3, 1] = -2
    elif what == "mobilization_endpoints":
        st.phase[0] = 4
        st.mob_from[0] = -1
    elif what == "mobilization_source":
        st.phase[1] = 4
        st.mob_from[1], st.mob_to[1] = 7, 8
        st.army[1, 7] = 1
    return st


@pytest.mark.parametrize("what", [
    "valid", "owner_range", "army_max", "empty_land",
    "negative_reinforcements", "negative_cards", "mobilization_endpoints",
    "mobilization_source"])
def test_validate_matches_jax(what):
    """The same verdict, and the same message, on played states and on
    states corrupted in one invariant."""
    cfg, jc = Config(), jconfig.Config()
    st = _corrupt(played_roots(8, 120, seed=9), what)
    verdicts = []
    for fn, s, c in ((TC.validate, st, cfg), (JC.validate, to_jax(st), jc)):
        try:
            fn(s, c)
            verdicts.append(None)
        except AssertionError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]
    assert (verdicts[0] is None) == (what == "valid")
