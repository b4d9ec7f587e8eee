"""Port parity: batched MCTS (descent, expansion, backup) and move choice.

The JAX search draws its chance outcomes with ``jax.random.categorical``.
The harness rebuilds the JAX key chain (one split per simulation,
``search.py:345-348``; ``kdesc``, ``:208``; one split per depth step,
``:184``) and hands the port the Gumbel noise that ``categorical`` adds
to the outcome logits.  A deterministic fake network gives both searches
the same priors and values.  On the CPU the port's descent and backup run
their plain versions (kernels K2 and K3 on the card).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.env.state import GameState as JGameState
from alphazero_risk_tpu.mcts import search as JM

from alphazero_risk_tpu_torch.config import PH_FORTIFY, Config
from alphazero_risk_tpu_torch.env import rules as TR
from alphazero_risk_tpu_torch.env import state as TS
from alphazero_risk_tpu_torch.mcts import search as TM

torch.set_num_threads(1)


def jax_eval(state, legal):
    w = (jnp.arange(43) % 3 + 1).astype(jnp.float32)
    pr = jnp.where(legal, w, 0.0)
    probs = pr / pr.sum(-1, keepdims=True)
    own = state.owner == state.cur_player[:, None]
    ta = (state.army * own).sum(-1)
    v = ((ta * 3 + own.sum(-1)) % 9 - 4).astype(jnp.float32) / 8.0
    return probs, v


def port_eval(state, legal):
    w = (torch.arange(43) % 3 + 1).to(torch.float32)
    pr = torch.where(legal, w, 0.0)
    probs = pr / pr.sum(-1, keepdim=True)
    own = state.owner == state.cur_player[:, None]
    ta = (state.army * own).sum(-1)
    v = ((ta * 3 + own.sum(-1)) % 9 - 4).to(torch.float32) / 8.0
    return probs, v


@functools.lru_cache(maxsize=None)
def _gumbel_chain(sims, depth, batch):
    @jax.jit
    def chain(key):
        out = []
        for _ in range(sims):
            key, sub = jax.random.split(key)
            _, k = jax.random.split(sub)
            row = []
            for _ in range(depth):
                k, ksel = jax.random.split(k)
                row.append(jax.random.gumbel(ksel, (batch, 3), jnp.float32))
            out.append(jnp.stack(row))
        return jnp.stack(out)
    return chain


def search_gumbel(key, sims, depth, batch):
    """[S, D, B, 3]: the noise jax.random.categorical adds at depth d of
    simulation s of ``search(root, key)``."""
    return torch.from_numpy(np.array(_gumbel_chain(sims, depth, batch)(key)))


def test_categorical_is_gumbel_argmax():
    """The contract the harness relies on, checked on the JAX side."""
    key = jax.random.PRNGKey(5)
    logits = jnp.log(jnp.asarray(np.random.default_rng(0).dirichlet(
        np.ones(3), 512), jnp.float32) + 1e-30)
    g = jax.random.gumbel(key, logits.shape, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, logits, axis=-1)),
        np.asarray(jnp.argmax(logits + g, axis=-1)))


def played_roots(batch, steps, seed):
    cfg = Config()
    gen = torch.Generator().manual_seed(seed)
    st = TS.new_game(batch, generator=gen, device="cpu")
    for _ in range(steps):
        legal = TR.legal_actions(st, cfg)
        g = torch.rand(legal.shape, generator=gen)
        st = TR.step_key(st, torch.argmax(torch.where(legal, g, -1.0), -1)
                         .to(torch.int32), gen, cfg)
    return st


def to_jax(ts):
    return JGameState(**{f.name: jnp.asarray(getattr(ts, f.name).numpy())
                         for f in dataclasses.fields(TS.GameState)})


@pytest.mark.parametrize("sims,max_depth", [(8, 12), (8, 2)])
def test_search_matches_jax(sims, max_depth):
    cfg = Config(mcts_simulations=sims, max_depth=max_depth)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    root = played_roots(12, 90, seed=sims + max_depth)
    assert (root.phase == 3).any(), "roots should include attack phases"
    key = jax.random.PRNGKey(7)
    jres = jax.jit(lambda r, k: JM.search(r, k, jc, jax_eval))(
        to_jax(root), key)
    gumbel = search_gumbel(key, sims, max_depth, root.batch_size)
    tres = TM.search(root, gumbel, cfg, port_eval)

    jt, tt = jres.tree, tres.tree
    for name in ("visit", "children", "next_free", "expanded", "terminal",
                 "player", "parent", "legal", "root"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    for name in ("wsum", "value", "prior"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    for f in dataclasses.fields(TS.GameState):
        np.testing.assert_array_equal(getattr(tt.states, f.name).numpy(),
                                      np.asarray(getattr(jt.states, f.name)),
                                      err_msg=f.name)
    # the tree really branched on chance outcomes
    assert (tt.children[..., 1:] >= 0).any()
    np.testing.assert_array_equal(tres.visit_counts.numpy(),
                                  np.asarray(jres.visit_counts))
    assert (tres.visit_counts.sum(-1) == sims).all()

    # move choice: argmax, and the sampled branch with the same noise
    jroot = to_jax(root)
    np.testing.assert_array_equal(
        TM.pick_move(tres, root, cfg, sample=False).numpy(),
        np.asarray(JM.pick_move(jres, jroot, key, jc, False)))
    g = jax.random.gumbel(key, (root.batch_size, 43), jnp.float32)
    np.testing.assert_array_equal(
        TM.pick_move(tres, root, cfg, sample=True,
                     gumbel=torch.from_numpy(np.array(g))).numpy(),
        np.asarray(JM.pick_move(jres, jroot, key, jc, True)))


def test_descend_backup_plain_invariants():
    """One more simulation on a grown tree: the path starts at the root,
    follows recorded child links, and backup adds exactly one visit per
    path edge."""
    cfg = Config(mcts_simulations=6, max_depth=10)
    root = played_roots(8, 120, seed=3)
    g = TM.draw_gumbel(torch.Generator().manual_seed(1), cfg, 8, "cpu")
    tree = TM.search(root, g, cfg, port_eval).tree
    path = TM.descend(tree, g[0], cfg)
    rows = torch.arange(8)
    assert (path.pn[:, 0] == tree.root).all()
    for b in range(8):
        for d in range(1, int(path.depth[b])):
            prev_n, prev_a = int(path.pn[b, d - 1]), int(path.pa[b, d - 1])
            assert int(path.pn[b, d]) in tree.children[b, prev_n,
                                                       prev_a].tolist()
    before = tree.visit.sum().item()
    TM.backup(tree, path, torch.zeros(8), tree.player[rows, path.cur.long()])
    assert tree.visit.sum().item() == before + int(path.depth.sum())


def test_root_noise_matches_jax():
    """The Dirichlet sample from the same uniforms (the 2048-point
    log-quantile Gamma(0.3) table, one interpolation, renormalised over the
    legal entries), and the blend into the root prior only.  exp, log and
    the interpolation run in another library: rtol 1e-5."""
    root = played_roots(12, 60, seed=4)
    legal = TR.legal_actions(root, Config())
    key = jax.random.PRNGKey(21)
    u = jax.random.uniform(key, (12, 43), jnp.float32, minval=1e-7,
                           maxval=1.0 - 1e-4)
    ref = np.asarray(JM.sample_dirichlet_noise(key, jnp.asarray(
        legal.numpy())))
    tu = torch.from_numpy(np.array(u))
    noise = TM.sample_dirichlet_noise(tu, legal)
    np.testing.assert_allclose(noise.numpy(), ref, rtol=1e-5, atol=1e-9)
    assert (noise[~legal] == 0).all()
    np.testing.assert_allclose(noise.sum(-1).numpy(), 1.0, rtol=1e-5)
    # uniforms at and beyond the table's ends take its end values
    edge = torch.tensor([[1e-9, TM.NOISE_U_MIN, 0.5, TM.NOISE_U_MAX, 1.0]])
    g = TM.sample_dirichlet_noise(edge, torch.ones(1, 5, dtype=torch.bool))
    torch.testing.assert_close(g[0, [0, 3]], g[0, [1, 4]], rtol=1e-4, atol=0)

    cfg = Config(mcts_simulations=8, max_depth=12, use_dirichlet_noise=True)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    jres = jax.jit(lambda r, k: JM.search(r, k, jc, jax_eval))(
        to_jax(root), key)
    k_sims, k_noise = jax.random.split(key)
    noise_u = torch.from_numpy(np.array(jax.random.uniform(
        k_noise, (12, 43), jnp.float32, minval=1e-7, maxval=1.0 - 1e-4)))
    tres = TM.search(root, search_gumbel(k_sims, 8, 12, 12), cfg, port_eval,
                     noise_u=noise_u)
    np.testing.assert_allclose(tres.tree.prior.numpy(),
                               np.asarray(jres.tree.prior), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_array_equal(tres.visit_counts.numpy(),
                                  np.asarray(jres.visit_counts))
    np.testing.assert_array_equal(tres.tree.children.numpy(),
                                  np.asarray(jres.tree.children))
    # only the root's prior was blended: node 1 holds the plain prior
    plain = TM.search(root, search_gumbel(k_sims, 8, 12, 12),
                      cfg.replace(use_dirichlet_noise=False), port_eval)
    assert not torch.equal(tres.tree.prior[:, 0], plain.tree.prior[:, 0])
    with pytest.raises(ValueError, match="noise_u"):
        TM.search(root, search_gumbel(k_sims, 8, 12, 12), cfg, port_eval)
    # under tree_reuse both packages search with 2 S + 2 nodes, the same
    # tree (the budget a carried subtree needs; tests/test_torch_reuse.py
    # holds the reuse itself)
    rcfg = cfg.replace(tree_reuse=True)
    jrc = jconfig.Config(**dataclasses.asdict(rcfg))
    jr = jax.jit(lambda r, k: JM.search(r, k, jrc, jax_eval))(
        to_jax(root), key)
    tr = TM.search(root, search_gumbel(k_sims, 8, 12, 12), rcfg, port_eval,
                   noise_u=noise_u)
    assert tuple(tr.tree.player.shape) == (12, rcfg.num_nodes) == (12, 18)
    for name in ("children", "visit", "next_free", "parent"):
        np.testing.assert_array_equal(getattr(tr.tree, name).numpy(),
                                      np.asarray(getattr(jr.tree, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tr.tree.prior.numpy(),
                               np.asarray(jr.tree.prior), rtol=1e-5,
                               atol=1e-9)


def test_draw_noise_uniform_contract():
    u = TM.draw_noise_uniform(torch.Generator().manual_seed(0), 64, "cpu")
    assert u.shape == (64, 43) and u.dtype == torch.float32
    assert (u >= TM.NOISE_U_MIN).all() and (u < TM.NOISE_U_MAX).all()


@pytest.mark.parametrize("threshold", [0, 30, 58])
def test_sampled_pick_move_matches_jax(threshold):
    """``pick_move`` with ``sample=True`` and the Gumbel noise of
    ``jax.random.categorical``: sampled up to the temperature-threshold
    round, argmax after it (0: all argmax, 58: all sampled)."""
    cfg = Config(mcts_simulations=8, max_depth=6,
                 temperature_threshold=threshold)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    root = played_roots(16, 70, seed=6)
    root = root.replace(round=torch.arange(16, dtype=torch.int32) * 3 + 8)
    key = jax.random.PRNGKey(2)
    jres = jax.jit(lambda r, k: JM.search(r, k, jc, jax_eval))(
        to_jax(root), key)
    tres = TM.search(root, search_gumbel(key, 8, 6, 16), cfg, port_eval)
    kp = jax.random.PRNGKey(33)
    g = torch.from_numpy(np.array(jax.random.gumbel(kp, (16, 43),
                                                    jnp.float32)))
    ref = np.asarray(JM.pick_move(jres, to_jax(root), kp, jc, True))
    got = TM.pick_move(tres, root, cfg, sample=True, gumbel=g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    greedy = TM.pick_move(tres, root, cfg, sample=False).numpy()
    late = (root.round > threshold).numpy()
    np.testing.assert_array_equal(got.numpy()[late], greedy[late])
    if threshold == 58:
        assert (got.numpy() != greedy).any()


def _assert_tree_equals_jax(tt, jt, msg):
    for name in ("expanded", "terminal", "value", "player", "parent",
                 "legal", "prior", "visit", "children", "next_free", "root"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=f"{msg} {name}")
    for f in dataclasses.fields(TS.GameState):
        t = getattr(tt.states, f.name)
        j = np.asarray(getattr(jt.states, f.name))
        assert t.numpy().dtype == j.dtype, f.name
        np.testing.assert_array_equal(t.numpy(), j,
                                      err_msg=f"{msg} state {f.name}")


@pytest.mark.parametrize("terminal_children", [False, True])
def test_write_nodes_plain_matches_jax_tree(terminal_children):
    """K6's plain version against the JAX tree, bit for bit: the root write
    after ``init_tree``, then the node value and the expansion write (state
    fields, tree arrays, child link, ``next_free``) after each of three
    ``simulate_once`` calls.  Finished games in the batch write nothing.
    With ``terminal_children`` four games sit in their last round's
    fortify phase, so every child they expand has ended (by the round
    cap) and takes its terminal value for its mover."""
    cfg = Config(mcts_simulations=3, max_depth=6)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    root = played_roots(12, 90, seed=9)
    # two finished games: a terminal root never expands
    root = root.replace(owner=torch.where(
        torch.arange(12)[:, None] < 2, torch.zeros_like(root.owner),
        root.owner))
    if terminal_children:
        last = (torch.arange(12) >= 2) & (torch.arange(12) < 6)
        root = root.replace(
            round=torch.where(last, cfg.max_game_rounds,
                              root.round).to(torch.int32),
            phase=torch.where(last, PH_FORTIFY, root.phase).to(torch.int32))
    assert (TR.game_status(root, cfg)[:2] != -1).all()
    assert (TR.game_status(root, cfg)[2:] == -1).all()
    jroot = to_jax(root)
    jt = JM.init_tree(jroot, jc, jax_eval)
    tt = TM.init_tree(root, cfg, port_eval)
    _assert_tree_equals_jax(tt, jt, "init_tree")
    key = jax.random.PRNGKey(13)
    gum = search_gumbel(key, 3, 6, 12)
    jsim = jax.jit(lambda t, k: JM.simulate_once(t, k, jc, jax_eval))
    for s in range(3):
        key, sub = jax.random.split(key)
        jt = jsim(jt, sub)
        tt = TM.simulate_once(tt, gum[s], cfg, port_eval)
        _assert_tree_equals_jax(tt, jt, f"simulation {s}")
        np.testing.assert_allclose(tt.wsum.numpy(), np.asarray(jt.wsum),
                                   rtol=1e-6, atol=0)
    # a descent that reaches a terminal child expands nothing, so only the
    # other games grow a node per simulation
    grown = slice(6 if terminal_children else 2, 12)
    assert (tt.next_free[:2] == 1).all() and (tt.next_free[grown] == 4).all()
    assert (tt.parent[grown, 1:4] >= 0).all()
    if terminal_children:
        child = tt.expanded[2:6, 1:]
        assert child.any() and tt.terminal[2:6, 1:][child].all()
        assert (tt.value[2:6, 1:][child].abs() == 1).any()


def test_write_nodes_plain_clamps_a_full_tree():
    """``idx`` is ``next_free`` clamped to the last node: a game whose tree
    is full overwrites that node and still counts."""
    cfg = Config(mcts_simulations=2, max_depth=6, max_nodes=3)
    root = played_roots(4, 60, seed=2)
    g = TM.draw_gumbel(torch.Generator().manual_seed(1),
                       cfg.replace(mcts_simulations=4), 4, "cpu")
    tree = TM.init_tree(root, cfg, port_eval)
    for s in range(4):
        tree = TM.simulate_once(tree, g[s], cfg, port_eval)
    assert (tree.next_free >= 3).all() and (tree.children < 3).all()
    assert (tree.visit[:, 0].sum(-1) == 4).all()


def test_reassigned_tree_array_drops_the_k6_pack():
    """K6 packs a tree's array pointers once (``search._k6_pack``) and
    keeps the pack on the tree; reassigning any field of the tree drops
    it, so a later write packs the new arrays, while in-place updates
    keep it."""
    cfg = Config(mcts_simulations=2, max_depth=4)
    tree = TM._empty_tree(played_roots(2, 10, seed=1), cfg)
    tree._k6 = "packed"
    tree.visit += 1
    assert tree.__dict__["_k6"] == "packed"
    tree.prior = tree.prior.clone()
    assert "_k6" not in tree.__dict__
