"""Batched array MCTS with exact chance nodes.

Port of ``alphazero_risk_tpu/mcts/search.py``.  Each simulation descends by
PUCT, sampling battle outcomes from ``OUTCOME_PROBS``, expands one node,
evaluates the network on the [B] leaf batch, and backs the value up with
sign flips only across player changes (alphazero_mcts.cpp:363-375).

Three kernels carry the simulation on the card:

- K2 (``csrc/mcts_descend.cu``, ``descend``): the whole descent, PUCT
  select and outcome sampling included, one warp per game;
- K6 (``csrc/tree_write.cu``, ``write_nodes``): the new node's state and
  tree entries, the child link, ``next_free`` and the leaf select; also the
  root write of ``init_tree``;
- K3 (``csrc/mcts_backup.cu``, ``backup``): the sign-flip backup, one
  warp per game.

On CPU tensors they take their plain PyTorch versions (``_descend_plain``,
``_write_nodes_plain``, ``_backup_plain``), which follow the JAX code step
by step.  The expansion's child state, status and legality come from one
launch of the rules kernel K7 (``rules.expand``), a root's legality and
status from K8 (``rules.state_views``), and the features of every
evaluation from K8 as well.

Randomness is explicit: ``search`` takes its chance noise as a tensor
``gumbel[S, max_depth, B, 3]``; outcome o at depth d of simulation s is
``argmax(log(p + 1e-30) + gumbel[s, d])``, which is how
``jax.random.categorical`` samples.  ``draw_gumbel`` draws it from a
generator.  Root Dirichlet noise (``cfg.use_dirichlet_noise``) takes one
uniform tensor ``noise_u[B, 43]`` (``draw_noise_uniform``).  The tree arrays
are updated in place (each search owns its tree).

Tree reuse (``cfg.tree_reuse``, the reference's ``trimNodes``): ``reroot``
compacts the played child's subtree to the front of the node arrays, and
``search_with_reuse`` continues from it where the carried root still equals
the game's state.  Both are plain tensor ops, run once per decision, and
hand the kernels a new tree, which K6 packs at its first write.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..config import (
    Config,
    NUM_ACTIONS,
    NUM_LANDS,
    PH_ATTACK,
    SKIP_ACTION,
    STATUS_DRAW,
    STATUS_NOT_ENDED,
)
from ..env import rules, topology
from ..env.rules import argmax_first, take
from ..env.state import GameState, tree_map
from .outcomes import OUTCOME_PROBS

I32, F32 = torch.int32, torch.float32
# The longest path K3 takes: it holds a game's edges in two 32-lane halves.
MAX_DEPTH = 64

# eval_fn(state, legal_mask) -> (probs [B,43] masked+normalized, value [B])
EvalFn = Callable[[GameState, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


@functools.lru_cache(maxsize=None)
def outcome_logp(device: torch.device) -> torch.Tensor:
    """[3, 2, 3] f32 log(OUTCOME_PROBS + 1e-30), the outcome logits."""
    p = torch.tensor(OUTCOME_PROBS, dtype=F32, device=device)
    return torch.log(p + 1e-30)


@dataclasses.dataclass
class Tree:
    states: GameState       # [B, N, ...]
    expanded: torch.Tensor  # [B, N] bool
    terminal: torch.Tensor  # [B, N] bool
    value: torch.Tensor     # [B, N] f32 — leaf value, node mover's view
    player: torch.Tensor    # [B, N] i32
    parent: torch.Tensor    # [B, N] i32 (-1 = root/unused)
    legal: torch.Tensor     # [B, N, 43] bool
    prior: torch.Tensor     # [B, N, 43] f32
    visit: torch.Tensor     # [B, N, 43] i32
    wsum: torch.Tensor      # [B, N, 43] f32
    children: torch.Tensor  # [B, N, 43, 3] i32 (-1 = unexpanded)
    next_free: torch.Tensor  # [B] i32
    root: torch.Tensor      # [B] i32 — current root node index

    # The arrays, the fields of ``states`` among them, are updated in place
    # and never reassigned: K6 keeps their pointers (``_k6_pack``).

    def __setattr__(self, name, value):
        # a field set to another object drops K6's pointer pack; an
        # in-place update (``+=``) keeps it
        if self.__dict__.get(name) is not value:
            self.__dict__.pop("_k6", None)
        object.__setattr__(self, name, value)


class SearchResult(NamedTuple):
    visit_counts: torch.Tensor  # [B, 43] root visit counts
    pi: torch.Tensor            # [B, 43] normalized tau=1 policy
    root_value: torch.Tensor    # [B] root network value
    tree: Tree


class Descent(NamedTuple):
    """One simulation's path: the output of ``descend``."""

    pn: torch.Tensor     # [B, D] i32 path nodes
    pa: torch.Tensor     # [B, D] i32 path actions
    pp: torch.Tensor     # [B, D] i32 path movers
    depth: torch.Tensor  # [B] i32 edges on the path
    cur: torch.Tensor    # [B] i32 last node reached
    exp_n: torch.Tensor  # [B] i32 node to expand from, -1 = none
    exp_a: torch.Tensor  # [B] i32 its action
    exp_o: torch.Tensor  # [B] i32 its chance outcome


def _rows(b: int, device) -> torch.Tensor:
    return torch.arange(b, device=device)


def _terminal_value(status: torch.Tensor, player: torch.Tensor):
    """+1 if the state's mover already won, -1 lost, 0 draw
    (alphazero_mcts.cpp:324-333)."""
    return torch.where(status == STATUS_DRAW, 0.0,
                       torch.where(status == player, 1.0, -1.0)).to(F32)


def _state_fields(state: GameState):
    return [getattr(state, f.name) for f in dataclasses.fields(GameState)]


def _write_nodes_plain(tree: Tree, src: GameState, status: torch.Tensor,
                       value: torch.Tensor, legal: torch.Tensor,
                       probs: torch.Tensor, path: Descent | None):
    """The node write in plain PyTorch: the node value of
    ``simulate_once:221-227`` (the terminal value of a finished state for
    its mover, else the network's), then masked index writes, field by
    field, as the JAX ``.at[].set`` chain."""
    b, n = tree.player.shape
    rows = _rows(b, tree.player.device)
    term = status != STATUS_NOT_ENDED
    node_value = torch.where(term, _terminal_value(status, src.cur_player),
                             value.to(F32))
    if path is None:
        expanding = torch.ones((b,), dtype=torch.bool,
                               device=tree.player.device)
        idx = torch.zeros((b,), dtype=torch.long, device=tree.player.device)
    else:
        root_done = tree.terminal[rows, tree.root.long()]
        expanding = (path.exp_n >= 0) & ~root_done
        en = path.exp_n.clamp(min=0).long()
        idx = torch.where(expanding, tree.next_free, 0).clamp(
            max=n - 1).long()

    def write(dst, val):
        m = expanding.reshape((b,) + (1,) * (val.dim() - 1))
        dst[rows, idx] = torch.where(m, val, dst[rows, idx])

    tree_map(write, tree.states, src)
    write(tree.expanded, torch.ones_like(expanding))
    write(tree.terminal, term)
    write(tree.value, node_value)
    write(tree.player, src.cur_player)
    write(tree.legal, legal)
    write(tree.prior, probs)
    if path is None:
        return None
    write(tree.parent, en.to(I32))
    cidx = (rows, en, path.exp_a.long(), path.exp_o.long())
    tree.children[cidx] = torch.where(expanding, idx.to(I32),
                                      tree.children[cidx])
    tree.next_free += expanding.to(I32)
    leaf_v = torch.where(expanding, node_value,
                         tree.value[rows, path.cur.long()])
    leaf_p = torch.where(expanding, src.cur_player,
                         tree.player[rows, path.cur.long()]).to(I32)
    return leaf_v, leaf_p


# The tree arrays K6 writes, after the 14 state fields: name, type, shape
# after [B, N] (None: the array is [B]).
def write_nodes(tree: Tree, src: GameState, status: torch.Tensor,
                value: torch.Tensor, legal: torch.Tensor,
                probs: torch.Tensor, path: Descent | None = None):
    """Write one node per game into the tree, in place: the root write
    without ``path``, else the expansion of one simulation.  Returns
    ``(leaf_v, leaf_p)`` with ``path``, else None."""
    return _write_nodes_plain(tree, src, status, value, legal, probs, path)


def _empty_tree(root: GameState, cfg: Config) -> Tree:
    """The tree arrays of a search over ``root``'s games, with no node
    written yet."""
    b, n, dev = root.batch_size, cfg.num_nodes, root.device

    def nodes(x):
        return torch.zeros((b, n) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=dev)

    return Tree(
        states=tree_map(nodes, root),
        expanded=torch.zeros((b, n), dtype=torch.bool, device=dev),
        terminal=torch.zeros((b, n), dtype=torch.bool, device=dev),
        value=torch.zeros((b, n), dtype=F32, device=dev),
        player=torch.zeros((b, n), dtype=I32, device=dev),
        legal=torch.zeros((b, n, NUM_ACTIONS), dtype=torch.bool, device=dev),
        prior=torch.zeros((b, n, NUM_ACTIONS), dtype=F32, device=dev),
        visit=torch.zeros((b, n, NUM_ACTIONS), dtype=I32, device=dev),
        wsum=torch.zeros((b, n, NUM_ACTIONS), dtype=F32, device=dev),
        parent=torch.full((b, n), -1, dtype=I32, device=dev),
        children=torch.full((b, n, NUM_ACTIONS, 3), -1, dtype=I32,
                            device=dev),
        next_free=torch.ones((b,), dtype=I32, device=dev),
        root=torch.zeros((b,), dtype=I32, device=dev),
    )


def root_inputs(root: GameState, cfg: Config, eval_fn: EvalFn):
    """What ``write_nodes`` writes into node 0: ``(state, status, network
    value, legal, prior)`` of the root, contiguous."""
    legal0, status0 = rules.state_views(root, cfg, legal=True, status=True)
    probs0, value0 = eval_fn(root, legal0)
    return (tree_map(lambda x: x.contiguous(), root), status0,
            value0.to(F32).contiguous(), legal0,
            probs0.to(F32).contiguous())


def init_tree(root: GameState, cfg: Config, eval_fn: EvalFn) -> Tree:
    tree = _empty_tree(root, cfg)
    write_nodes(tree, *root_inputs(root, cfg, eval_fn))
    return tree


def _puct_select(tree: Tree, n: torch.Tensor, cfg: Config) -> torch.Tensor:
    rows = _rows(n.shape[0], n.device)
    n = n.long()
    legal = tree.legal[rows, n]
    prior = tree.prior[rows, n]
    visit = tree.visit[rows, n]
    wsum = tree.wsum[rows, n]
    sum_n = visit.sum(-1, keepdim=True).to(F32)
    q = wsum / visit.clamp(min=1).to(F32)
    noised = (1.0 - cfg.noise_eps) * prior + cfg.noise_eps * cfg.noise_value
    u = q + noised * cfg.cpuct * torch.sqrt(1.0 + sum_n) / (
        1.0 + visit.to(F32))
    u = torch.where(legal, u, float("-inf"))
    return argmax_first(u)


def _sample_outcome(tree: Tree, n: torch.Tensor, action: torch.Tensor,
                    gumbel: torch.Tensor) -> torch.Tensor:
    """Chance outcome for attack edges (exact probs); 0 otherwise.
    ``gumbel`` [B, 3] is this depth step's noise."""
    rows = _rows(n.shape[0], n.device)
    n = n.long()
    st = tree.states
    phase = st.phase[rows, n]
    army = st.army[rows, n]
    owner = st.owner[rows, n]
    player = tree.player[rows, n]
    li = action.clamp(0, NUM_LANDS - 1)
    owned_wa = (owner == player[:, None]) & (army >= 2)
    frm = rules.best_attack_from_army(army, li, owned_wa)
    att_n, def_n, _ = rules.battle_comparisons(take(army, frm),
                                               take(army, li))
    logp = outcome_logp(n.device)[(att_n - 1).long(), (def_n - 1).long()]
    o = argmax_first(logp + gumbel)
    is_battle = (phase == PH_ATTACK) & (action != SKIP_ACTION)
    return torch.where(is_battle, o, 0).to(I32)


def _descend_plain(tree: Tree, gumbel: torch.Tensor,
                   cfg: Config) -> Descent:
    """The descent of ``simulate_once`` in plain PyTorch, step by step as
    the JAX ``while_loop`` (one host check per depth step)."""
    b = tree.player.shape[0]
    dev = tree.player.device
    rows = _rows(b, dev)
    d_cap = cfg.max_depth
    pn = torch.zeros((b, d_cap), dtype=I32, device=dev)
    pa = torch.zeros_like(pn)
    pp = torch.zeros_like(pn)
    cur = tree.root.clone()
    depth = torch.zeros((b,), dtype=I32, device=dev)
    done = tree.terminal[rows, cur.long()]
    exp_n = torch.full((b,), -1, dtype=I32, device=dev)
    exp_a = torch.zeros((b,), dtype=I32, device=dev)
    exp_o = torch.zeros((b,), dtype=I32, device=dev)
    for step in range(d_cap):
        if not bool((~done).any()):
            break
        a = _puct_select(tree, cur, cfg)
        o = _sample_outcome(tree, cur, a, gumbel[step])
        child = tree.children[rows, cur.long(), a.long(), o.long()]
        act = ~done
        # a finished game may sit at depth == max_depth: clamp, and write
        # its own entry back (the JAX scatter drops such writes)
        dc = depth.clamp(max=d_cap - 1)
        dl = dc.long()[:, None]
        pn.scatter_(1, dl, torch.where(act, cur, take(pn, dc))[:, None])
        pa.scatter_(1, dl, torch.where(act, a, take(pa, dc))[:, None])
        pp.scatter_(1, dl, torch.where(
            act, tree.player[rows, cur.long()], take(pp, dc))[:, None])
        new_depth = torch.where(act, depth + 1, depth)
        unexp = act & (child < 0)
        term = act & (child >= 0) & tree.terminal[rows,
                                                  child.clamp(min=0).long()]
        exp_n = torch.where(unexp, cur, exp_n)
        exp_a = torch.where(unexp, a, exp_a)
        exp_o = torch.where(unexp, o, exp_o)
        cur = torch.where(act & (child >= 0), child.clamp(min=0), cur)
        done = done | unexp | term | (new_depth >= d_cap)
        depth = new_depth
    return Descent(pn, pa, pp, depth, cur, exp_n, exp_a, exp_o)


def descend(tree: Tree, gumbel: torch.Tensor, cfg: Config) -> Descent:
    """One simulation's descent from each game's root; ``gumbel``
    [max_depth, B, 3] f32 is the outcome noise of this simulation."""
    return _descend_plain(tree, gumbel, cfg)


def _backup_plain(tree: Tree, path: Descent, leaf_v: torch.Tensor,
                  leaf_p: torch.Tensor) -> None:
    """Closed-form backup of the JAX code: suffix product of the sign
    flips, one scatter-add per stat array."""
    pn, pa, pp, depth = path.pn, path.pa, path.pp, path.depth
    b, d_cap = pn.shape
    dev = pn.device
    d_idx = torch.arange(d_cap, device=dev)[None, :]
    active = d_idx < depth[:, None]
    child_p = torch.cat([pp[:, 1:], pp[:, -1:]], dim=1)
    child_p = torch.where(d_idx == depth[:, None] - 1, leaf_p[:, None],
                          child_p)
    signs = torch.where((pp == child_p) | ~active, 1.0, -1.0)
    suffix = torch.cumprod(signs.flip(1), dim=1).flip(1)
    v_d = leaf_v[:, None] * suffix
    rows = _rows(b, dev)[:, None].expand(b, d_cap)
    idx = (rows, pn.long(), pa.long())
    tree.visit.index_put_(idx, active.to(I32), accumulate=True)
    tree.wsum.index_put_(idx, v_d * active.to(F32), accumulate=True)


def backup(tree: Tree, path: Descent, leaf_v: torch.Tensor,
           leaf_p: torch.Tensor) -> None:
    """Add one visit and the sign-flipped leaf value along each game's path,
    in place on ``tree.visit`` and ``tree.wsum``."""
    _backup_plain(tree, path, leaf_v, leaf_p)


def expansion_inputs(tree: Tree, path: Descent, cfg: Config,
                     eval_fn: EvalFn):
    """What ``write_nodes`` writes for one simulation: ``(child state,
    status, network value, legal, prior)`` of the node each game would
    expand: the child of node ``exp_n`` (``rules.expand``, K7 on the card,
    whose outputs are fresh contiguous tensors) and the network on it."""
    child_state, status, legal_c = rules.expand(
        tree.states, path.exp_n, path.exp_a, path.exp_o, cfg)
    probs_c, value_c = eval_fn(child_state, legal_c)
    return child_state, status, value_c.to(F32), legal_c, probs_c.to(F32)


def simulate_once(tree: Tree, gumbel: torch.Tensor, cfg: Config,
                  eval_fn: EvalFn) -> Tree:
    """One simulation for every game; ``gumbel`` [max_depth, B, 3].

    On the card the leaf value and mover that K6 returns are buffers of
    the tree, which the next simulation's K6 rewrites: K3 reads them here,
    in stream order, and nothing keeps them."""
    path = descend(tree, gumbel, cfg)
    leaf_v, leaf_p = write_nodes(
        tree, *expansion_inputs(tree, path, cfg, eval_fn), path)
    backup(tree, path, leaf_v, leaf_p)
    return tree


def draw_gumbel(generator: torch.Generator, cfg: Config, batch: int,
                device) -> torch.Tensor:
    """[S, max_depth, B, 3] standard Gumbel noise for one ``search``."""
    shape = (cfg.mcts_simulations, cfg.max_depth, batch, 3)
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp(min=torch.finfo(F32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


NOISE_U_MIN, NOISE_U_MAX = 1e-7, 1.0 - 1e-4


@functools.lru_cache(maxsize=4)
def _gamma_log_quantiles(alpha: float, n: int = 2048):
    """Log-quantile table of Gamma(alpha) on a log-uniform grid: root noise
    needs iid Gamma(0.3) draws, and one interpolation in a 2048-point
    inverse-CDF table in log-log space gives them from uniforms (the
    quantile function is nearly linear there for small u, so the low tail
    that dominates alpha=0.3 stays accurate).  Returns float32 numpy
    arrays ``(log u grid, log quantile)``."""
    from scipy.stats import gamma as sp_gamma

    lu = np.linspace(np.log(NOISE_U_MIN), np.log(NOISE_U_MAX), n)
    q = sp_gamma.ppf(np.exp(lu), a=alpha)
    return lu.astype(np.float32), np.log(q).astype(np.float32)


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp``: piecewise linear, constant outside the grid."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    f = fp[i - 1] + ((x - xp[i - 1]) / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def sample_dirichlet_noise(u: torch.Tensor, legal: torch.Tensor,
                           alpha: float = 0.3) -> torch.Tensor:
    """Dirichlet(alpha) over the legal subset of each row, from uniforms
    ``u`` [B, 43] in ``[NOISE_U_MIN, NOISE_U_MAX)``: independent
    Gamma(alpha) draws renormalized over the legal entries."""
    lu, lq = (torch.from_numpy(a).to(u.device)
              for a in _gamma_log_quantiles(float(alpha)))
    g = torch.exp(_interp(torch.log(u), lu, lq))
    g = torch.where(legal, g, 0.0)
    return g / g.sum(-1, keepdim=True).clamp(min=1e-30)


def _apply_root_noise(tree: Tree, u: torch.Tensor, cfg: Config) -> Tree:
    """Sampled Dirichlet noise blended into the root prior only (the
    constant blend of ``_puct_select`` applies at every node besides)."""
    rows = _rows(tree.root.shape[0], tree.root.device)
    r = tree.root.long()
    noise = sample_dirichlet_noise(u, tree.legal[rows, r])
    tree.prior[rows, r] = ((1.0 - cfg.noise_eps) * tree.prior[rows, r]
                           + cfg.noise_eps * noise)
    return tree


def draw_noise_uniform(generator: torch.Generator, batch: int,
                       device) -> torch.Tensor:
    """[B, 43] uniforms in ``[NOISE_U_MIN, NOISE_U_MAX)`` for the root
    noise of one ``search``."""
    u = torch.rand((batch, NUM_ACTIONS), generator=generator,
                   device=generator.device)
    return (NOISE_U_MIN + u * (NOISE_U_MAX - NOISE_U_MIN)).to(device)


def _run_search(tree: Tree, gumbel: torch.Tensor, cfg: Config,
                eval_fn: EvalFn, noise_u: torch.Tensor | None
                ) -> SearchResult:
    """Root noise, then ``cfg.mcts_simulations`` simulations on ``tree``."""
    if cfg.use_dirichlet_noise:
        if noise_u is None:
            raise ValueError("use_dirichlet_noise needs noise_u [B, 43]")
        tree = _apply_root_noise(tree, noise_u, cfg)
    for s in range(cfg.mcts_simulations):
        tree = simulate_once(tree, gumbel[s], cfg, eval_fn)
    rows = _rows(tree.root.shape[0], tree.root.device)
    counts = tree.visit[rows, tree.root.long()]
    pi = counts.to(F32)
    pi = pi / pi.sum(-1, keepdim=True).clamp(min=1e-9)
    return SearchResult(visit_counts=counts, pi=pi,
                        root_value=tree.value[rows, tree.root.long()],
                        tree=tree)


def search(root: GameState, gumbel: torch.Tensor, cfg: Config,
           eval_fn: EvalFn, noise_u: torch.Tensor | None = None
           ) -> SearchResult:
    """Run ``cfg.mcts_simulations`` sims for every game in the batch;
    ``gumbel`` [S, max_depth, B, 3] is the chance noise of the search and
    ``noise_u`` [B, 43] the uniforms of the root Dirichlet noise (needed
    with ``cfg.use_dirichlet_noise``)."""
    # every expansion is a step_with_outcome: simple cards only
    rules.require_uniform(cfg, None)
    return _run_search(init_tree(root, cfg, eval_fn), gumbel, cfg, eval_fn,
                       noise_u)


def pick_move(result: SearchResult, state: GameState, cfg: Config,
              sample: bool, gumbel: torch.Tensor | None = None
              ) -> torch.Tensor:
    """tau=1 visit-count policy: argmax, or (``sample``) a draw below the
    temperature-threshold round with ``gumbel`` [B, 43] noise
    (alphazero_trainer.cpp:99-106, alphazero_mcts.cpp:379-412)."""
    greedy = argmax_first(result.pi)
    if not sample:
        return greedy
    sampled = argmax_first(torch.log(result.pi + 1e-30) + gumbel)
    do_sample = state.round <= cfg.temperature_threshold
    return torch.where(do_sample, sampled, greedy).to(I32)
