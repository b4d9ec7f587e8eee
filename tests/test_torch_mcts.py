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

from alphazero_risk_tpu_torch.config import Config
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
