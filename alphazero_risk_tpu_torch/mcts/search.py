"""Batched array MCTS with exact chance nodes.

Port of ``alphazero_risk_tpu/mcts/search.py``.  Each simulation descends by
PUCT, sampling battle outcomes from ``OUTCOME_PROBS``, expands one node,
evaluates the network on the [B] leaf batch, and backs the value up with
sign flips only across player changes (alphazero_mcts.cpp:363-375).

Two kernels carry the simulation on the card:

- K2 (``csrc/mcts_descend.cu``, ``descend``): the whole descent, PUCT
  select and outcome sampling included, one thread per game;
- K3 (``csrc/mcts_backup.cu``, ``backup``): the sign-flip backup.

On CPU tensors both take their plain PyTorch versions (``_descend_plain``,
``_backup_plain``), which follow the JAX code step by step.  The expansion
(rules transition, legality, network) stays plain PyTorch.

Randomness is explicit: ``search`` takes its chance noise as a tensor
``gumbel[S, max_depth, B, 3]``; outcome o at depth d of simulation s is
``argmax(log(p + 1e-30) + gumbel[s, d])``, which is how
``jax.random.categorical`` samples.  ``draw_gumbel`` draws it from a
generator.  The tree arrays are updated in place (each search owns its
tree).  Tree reuse and root Dirichlet noise are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Tuple

import torch

from .. import kernels
from ..config import (
    Config,
    NUM_ACTIONS,
    NUM_LANDS,
    PH_ATTACK,
    SKIP_ACTION,
    STATUS_DRAW,
    STATUS_NOT_ENDED,
)
from ..env import rules
from ..env.rules import argmax_first, take
from ..env.state import GameState, tree_map
from .outcomes import OUTCOME_PROBS

I32, F32 = torch.int32, torch.float32

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


def _gather_state(states: GameState, n: torch.Tensor) -> GameState:
    rows = _rows(n.shape[0], n.device)
    return tree_map(lambda x: x[rows, n.long()], states)


def _terminal_value(status: torch.Tensor, player: torch.Tensor):
    """+1 if the state's mover already won, -1 lost, 0 draw
    (alphazero_mcts.cpp:324-333)."""
    return torch.where(status == STATUS_DRAW, 0.0,
                       torch.where(status == player, 1.0, -1.0)).to(F32)


def init_tree(root: GameState, cfg: Config, eval_fn: EvalFn) -> Tree:
    b, n, dev = root.batch_size, cfg.num_nodes, root.device

    def nodes(x):
        out = torch.zeros((b, n) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[:, 0] = x
        return out

    legal0 = rules.legal_actions(root, cfg)
    probs0, value0 = eval_fn(root, legal0)
    status0 = rules.game_status(root, cfg)
    term0 = status0 != STATUS_NOT_ENDED
    return Tree(
        states=tree_map(nodes, root),
        expanded=nodes(torch.ones((b,), dtype=torch.bool, device=dev)),
        terminal=nodes(term0),
        value=nodes(torch.where(
            term0, _terminal_value(status0, root.cur_player),
            value0.to(F32))),
        player=nodes(root.cur_player),
        legal=nodes(legal0),
        prior=nodes(probs0.to(F32)),
        visit=torch.zeros((b, n, NUM_ACTIONS), dtype=I32, device=dev),
        wsum=torch.zeros((b, n, NUM_ACTIONS), dtype=F32, device=dev),
        parent=torch.full((b, n), -1, dtype=I32, device=dev),
        children=torch.full((b, n, NUM_ACTIONS, 3), -1, dtype=I32,
                            device=dev),
        next_free=torch.ones((b,), dtype=I32, device=dev),
        root=torch.zeros((b,), dtype=I32, device=dev),
    )


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
    """One simulation's descent from each game's root (kernel K2).

    ``gumbel`` [max_depth, B, 3] f32 is the outcome noise of this
    simulation.  CPU tensors take ``_descend_plain``; CUDA tensors launch
    the kernel (no fallback)."""
    if tree.visit.device.type == "cpu":
        return _descend_plain(tree, gumbel, cfg)
    b, n = tree.player.shape
    d_cap = cfg.max_depth
    dev = tree.visit.device
    st = tree.states
    logp = outcome_logp(dev)
    nrank = rules.tables(dev).neighbor_rank
    ins = (tree.root, tree.terminal, tree.player, tree.legal, tree.prior,
           tree.visit, tree.wsum, tree.children, st.phase, st.army,
           st.owner, gumbel, logp, nrank)
    kernels.require_cuda(*ins)
    if tuple(gumbel.shape) != (d_cap, b, 3) or gumbel.dtype != F32:
        raise ValueError("gumbel must be [max_depth, B, 3] float32")
    out = Descent(*(torch.empty((b, d_cap), dtype=I32, device=dev)
                    for _ in range(3)),
                  *(torch.empty((b,), dtype=I32, device=dev)
                    for _ in range(5)))
    c_keep = 1.0 - cfg.noise_eps
    c_add = cfg.noise_eps * cfg.noise_value
    P = kernels.ptr
    kernels.MCTS_DESCEND.launch(
        *(P(t) for t in ins), c_keep, c_add, cfg.cpuct, b, n, d_cap,
        *(P(t) for t in out))
    return out


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
    """Add one visit and the sign-flipped leaf value along each game's path
    (kernel K3), in place on ``tree.visit`` and ``tree.wsum``.  CPU tensors
    take ``_backup_plain``; CUDA tensors launch the kernel."""
    if tree.visit.device.type == "cpu":
        _backup_plain(tree, path, leaf_v, leaf_p)
        return
    ins = (path.pn, path.pa, path.pp, path.depth, leaf_v, leaf_p,
           tree.visit, tree.wsum)
    kernels.require_cuda(*ins)
    if leaf_v.dtype != F32 or leaf_p.dtype != I32:
        raise ValueError("leaf_v must be float32 and leaf_p int32")
    b, n = tree.player.shape
    P = kernels.ptr
    kernels.MCTS_BACKUP.launch(*(P(t) for t in ins), b, n,
                               path.pn.shape[1])


def simulate_once(tree: Tree, gumbel: torch.Tensor, cfg: Config,
                  eval_fn: EvalFn) -> Tree:
    """One simulation for every game; ``gumbel`` [max_depth, B, 3]."""
    b = tree.player.shape[0]
    rows = _rows(b, tree.player.device)
    path = descend(tree, gumbel, cfg)

    root_done = tree.terminal[rows, tree.root.long()]
    expanding = (path.exp_n >= 0) & ~root_done
    en = path.exp_n.clamp(min=0).long()

    # ---- expansion ----
    parent = _gather_state(tree.states, en)
    child_state = rules.step_with_outcome(parent, path.exp_a, path.exp_o,
                                          cfg)
    status = rules.game_status(child_state, cfg)
    term = status != STATUS_NOT_ENDED
    legal_c = rules.legal_actions(child_state, cfg)
    probs_c, value_c = eval_fn(child_state, legal_c)
    node_value = torch.where(
        term, _terminal_value(status, child_state.cur_player),
        value_c.to(F32))

    idx = torch.where(expanding, tree.next_free, 0).clamp(
        max=cfg.num_nodes - 1).long()

    def write(dst, src):
        m = expanding.reshape((b,) + (1,) * (src.dim() - 1))
        dst[rows, idx] = torch.where(m, src, dst[rows, idx])

    tree_map(write, tree.states, child_state)
    write(tree.expanded, torch.ones_like(expanding))
    write(tree.terminal, term)
    write(tree.value, node_value)
    write(tree.player, child_state.cur_player)
    write(tree.parent, en.to(I32))
    write(tree.legal, legal_c)
    write(tree.prior, probs_c.to(F32))
    cidx = (rows, en, path.exp_a.long(), path.exp_o.long())
    tree.children[cidx] = torch.where(expanding, idx.to(I32),
                                      tree.children[cidx])
    tree.next_free += expanding.to(I32)

    # ---- leaf value, backup ----
    leaf_v = torch.where(expanding, node_value,
                         tree.value[rows, path.cur.long()])
    leaf_p = torch.where(expanding, child_state.cur_player,
                         tree.player[rows, path.cur.long()]).to(I32)
    backup(tree, path, leaf_v.contiguous(), leaf_p.contiguous())
    return tree


def draw_gumbel(generator: torch.Generator, cfg: Config, batch: int,
                device) -> torch.Tensor:
    """[S, max_depth, B, 3] standard Gumbel noise for one ``search``."""
    shape = (cfg.mcts_simulations, cfg.max_depth, batch, 3)
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp(min=torch.finfo(F32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def search(root: GameState, gumbel: torch.Tensor, cfg: Config,
           eval_fn: EvalFn) -> SearchResult:
    """Run ``cfg.mcts_simulations`` sims for every game in the batch;
    ``gumbel`` [S, max_depth, B, 3] is the chance noise of the search."""
    if cfg.use_dirichlet_noise or cfg.tree_reuse:
        raise NotImplementedError(
            "root Dirichlet noise and tree reuse are not ported yet")
    tree = init_tree(root, cfg, eval_fn)
    for s in range(cfg.mcts_simulations):
        tree = simulate_once(tree, gumbel[s], cfg, eval_fn)
    rows = _rows(root.batch_size, root.device)
    counts = tree.visit[rows, tree.root.long()]
    pi = counts.to(F32)
    pi = pi / pi.sum(-1, keepdim=True).clamp(min=1e-9)
    return SearchResult(visit_counts=counts, pi=pi,
                        root_value=tree.value[rows, tree.root.long()],
                        tree=tree)


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
