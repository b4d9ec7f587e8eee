"""Port parity: the plain versions of kernels K2 (the descent) and K8 (the
state views) against the JAX package, on the cases where a reduction
across a warp could pick another index than a sequential scan.

On the card K2 takes its PUCT argmax and its attack source by butterflies
over (value, index) pairs, and K8 builds its masks by ballots and OR and
add reductions over the lanes; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold both kernels bit for bit against the
plain versions, on the same crafted trees (``chip_smoke.tie_tree``).  Here those plain versions are pinned to the JAX
functions on crafted trees (every legal action tied, rows with no legal
action, attack sources with equal armies or none at all) and on ragged
batches (1, 31, 33, 65 games) of every phase, feature versions 1-3 and a
0/0 army share.

The attack source is the first maximum of ``(army - 1) * 8 - rank`` over
the mover's armed neighbours of the target, -1 elsewhere.  Ranks are
distinct and below 8, so two sources never tie on the score itself: equal
armies are what the neighbour rank must break, and a target with no
source leaves every land tied at -1 (land 0 wins).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_risk_tpu import config as jconfig
from alphazero_risk_tpu.env import rules as JR
from alphazero_risk_tpu.env.featurize import featurize as jax_featurize
from alphazero_risk_tpu.mcts import search as JM

from alphazero_risk_tpu_torch.config import Config, PH_ATTACK
from alphazero_risk_tpu_torch.env import rules as TR
from alphazero_risk_tpu_torch.env import state as TS
from alphazero_risk_tpu_torch.env.featurize import _featurize_plain
from alphazero_risk_tpu_torch.mcts import search as TM

from chip_smoke import TIE_CASES, tie_tree
from test_torch_mcts import (_assert_tree_equals_jax, jax_eval, played_roots,
                             port_eval, search_gumbel, to_jax)

torch.set_num_threads(1)

B, SIMS = 12, 8
CASES = ("grown",) + TIE_CASES


def crafted_tree(case: str, max_depth: int = 48):
    """A tree grown by the plain search (B games, SIMS simulations), kept
    as it is (``grown``) or rewritten by ``tie_tree`` into ``case``."""
    cfg = Config(mcts_simulations=SIMS, max_depth=max_depth)
    root = played_roots(B, 90, seed=5)
    gum = TM.draw_gumbel(torch.Generator().manual_seed(5), cfg, B, "cpu")
    tree = TM.search(root, gum, cfg, port_eval).tree
    return (tree if case == "grown" else tie_tree(tree, case)), cfg


def to_jax_tree(tree):
    return JM.Tree(**{
        f.name: (to_jax(tree.states) if f.name == "states"
                 else jnp.asarray(getattr(tree, f.name).numpy()))
        for f in dataclasses.fields(tree)})


_jax_puct = jax.jit(JM._puct_select, static_argnums=2)


@pytest.mark.parametrize("case", CASES)
def test_puct_select_matches_jax(case):
    """``_puct_select`` (first-index argmax of U over the legal actions)
    at every node of the crafted trees, unexpanded nodes (no legal action)
    included."""
    tree, cfg = crafted_tree(case)
    jtree, jc = to_jax_tree(tree), jconfig.Config(**dataclasses.asdict(cfg))
    n_nodes = tree.player.shape[1]
    picked = []
    for k in range(n_nodes):
        n = torch.full((B,), k, dtype=torch.int32)
        got = TM._puct_select(tree, n, cfg)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(_jax_puct(jtree, jnp.asarray(n.numpy()),
                                              jc)), err_msg=f"node {k}")
        picked.append(got)
    picked = torch.stack(picked, 1)
    has_legal = tree.legal.any(-1)
    # a row without a legal action takes index 0
    assert bool((picked[~has_legal] == 0).all()) and bool((~has_legal).any())
    if case != "grown":
        # every legal action ties: the first one wins
        first = TR.argmax_first(tree.legal)
        assert torch.equal(picked[has_legal], first[has_legal])
        assert bool((tree.legal.sum(-1) >= 2).any())


@pytest.mark.parametrize("case", CASES)
def test_sample_outcome_matches_jax(case):
    """The attack source (``best_attack_from_army``) for every target of
    every node, and ``_sample_outcome`` on the PUCT action with the Gumbel
    noise of ``jax.random.categorical``'s key."""
    tree, cfg = crafted_tree(case)
    jtree = to_jax_tree(tree)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    st = tree.states
    n_nodes = tree.player.shape[1]
    army = st.army.reshape(-1, 1, 42).expand(-1, 42, 42).reshape(-1, 42)
    owa = ((st.owner == tree.player[..., None]) & (st.army >= 2)).reshape(
        -1, 1, 42).expand(-1, 42, 42).reshape(-1, 42)
    target = torch.arange(42, dtype=torch.int32).repeat(B * n_nodes)
    frm = TR.best_attack_from_army(army.contiguous(), target,
                                   owa.contiguous())
    np.testing.assert_array_equal(
        frm.numpy(), np.asarray(JR.best_attack_from_army(
            jnp.asarray(army.numpy()), jnp.asarray(target.numpy()),
            jnp.asarray(owa.numpy()))))
    adj = torch.from_numpy(np.array(JR.ADJ))[target.long()]
    sources = (adj & owa).sum(-1)
    if case == "equal_armies":
        assert bool((sources >= 2).any())   # equal armies, rank decides
    if case == "no_source":
        assert bool((sources == 0).all()) and bool((frm == 0).all())
    battles = 0
    for k in range(n_nodes):
        n = torch.full((B,), k, dtype=torch.int32)
        a = TM._puct_select(tree, n, cfg)
        key = jax.random.PRNGKey(100 + k)
        g = torch.from_numpy(np.array(jax.random.gumbel(key, (B, 3),
                                                        jnp.float32)))
        got = TM._sample_outcome(tree, n, a, g)
        ref = JM._sample_outcome(jtree, jnp.asarray(n.numpy()),
                                 jnp.asarray(a.numpy()), key)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=f"node {k}")
        battles += int(((st.phase[:, k] == PH_ATTACK) & (a != 42)).sum())
    assert battles > 0


@pytest.mark.parametrize("case,max_depth", [(c, 48) for c in CASES]
                         + [("grown", 2)])
def test_simulate_once_on_crafted_trees_matches_jax(case, max_depth):
    """One more simulation on each crafted tree, JAX against the port
    (descent, expansion, backup): the path the plain descent takes through
    the ties is the JAX one, also where ``max_depth`` cuts it."""
    tree, cfg = crafted_tree(case, max_depth)
    jtree = to_jax_tree(tree)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    key = jax.random.PRNGKey(21)
    gum = search_gumbel(key, 1, max_depth, B)[0]
    _, sub = jax.random.split(key)
    path = TM.descend(tree, gum, cfg)
    jtree = jax.jit(lambda t, k: JM.simulate_once(t, k, jc, jax_eval))(
        jtree, sub)
    tree = TM.simulate_once(tree, gum, cfg, port_eval)
    _assert_tree_equals_jax(tree, jtree, case)
    np.testing.assert_allclose(tree.wsum.numpy(), np.asarray(jtree.wsum),
                               rtol=1e-6, atol=0)
    assert int(path.depth.max()) <= max_depth
    if max_depth == 2:
        assert bool((path.depth == 2).any())   # the cap cuts some paths


def view_states(batch: int):
    """``batch`` games of random play in every phase, the first with no
    army on either player's lands (a 0/0 army share)."""
    cfg = Config()
    gen = torch.Generator().manual_seed(batch)
    st = TS.new_game(16, generator=gen, device="cpu")
    snaps = []
    for t in range(400):
        legal = TR.legal_actions(st, cfg)
        a = torch.argmax(torch.where(legal, torch.rand(legal.shape,
                                                       generator=gen), -1.0),
                         -1).to(torch.int32)
        st = TR.step_key(st, a, gen, cfg)
        if t % 7 == 0:
            snaps.append(st)
    pool = TS.tree_map(lambda *xs: torch.cat(xs), *snaps)
    pick = torch.randperm(pool.batch_size, generator=gen)[:batch]
    out = TS.tree_map(lambda x: x[pick].clone(), pool)
    out.owner[0] = 2
    return out


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 31, 33, 65])
def test_state_views_plain_match_jax(batch, version):
    """``_state_views_plain`` (legality, status and features from one
    call, K8's plain version) against JAX ``legal_actions``,
    ``game_status`` and ``featurize``, bit for bit, NaN where the army
    share is 0/0."""
    cfg = Config(feature_version=version)
    jc = jconfig.Config(**dataclasses.asdict(cfg))
    st = view_states(batch)
    js = to_jax(st)
    legal, status, feats = TR._state_views_plain(st, cfg, True, True, True)
    np.testing.assert_array_equal(legal.numpy(),
                                  np.asarray(JR.legal_actions(js, jc)))
    np.testing.assert_array_equal(status.numpy(),
                                  np.asarray(JR.game_status(js, jc)))
    ref = np.asarray(jax_featurize(js, jc))
    np.testing.assert_array_equal(feats.numpy(), ref)
    np.testing.assert_array_equal(_featurize_plain(st, cfg).numpy(), ref)
    assert np.isnan(ref[0]).any() == (version >= 2)
    if batch == 65:
        assert set(st.phase.tolist()) == set(range(6))
