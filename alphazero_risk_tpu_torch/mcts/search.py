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

import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple, Tuple

import numpy as np
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
_K6_ARRAYS = (("expanded", torch.bool, ()), ("terminal", torch.bool, ()),
              ("value", F32, ()), ("player", I32, ()), ("parent", I32, ()),
              ("legal", torch.bool, (NUM_ACTIONS,)),
              ("prior", F32, (NUM_ACTIONS,)),
              ("children", I32, (NUM_ACTIONS, 3)), ("next_free", I32, None),
              ("root", I32, None))
_STATE_SPEC = rules.STATE_SPEC + rules.CARDS_SPEC


def _k6_pack(tree: Tree):
    """The kernels' view of a tree on the card, made at its first write
    (the root write of ``init_tree``) and kept on the tree: K6's 24
    arrays, checked once, the leaf outputs, allocated once, and K3's
    ``visit`` and ``wsum``, checked once, as one host array of pointers;
    with its address and the leaf outputs.  K3 reads the leaf outputs in
    stream order before the next simulation's K6 writes them."""
    pack = tree.__dict__.get("_k6")
    if pack is None:
        b, n = tree.player.shape
        arrays = rules.state_fields(tree.states, (b, n), _STATE_SPEC)
        arrays += [rules.checked(getattr(tree, name), dtype,
                                 (b,) if tail is None else (b, n) + tail,
                                 name)
                   for name, dtype, tail in _K6_ARRAYS]
        dev = tree.player.device
        leaf = (torch.empty((b,), dtype=F32, device=dev),
                torch.empty((b,), dtype=I32, device=dev))
        stats = (rules.checked(tree.visit, I32, (b, n, NUM_ACTIONS), "visit"),
                 rules.checked(tree.wsum, F32, (b, n, NUM_ACTIONS), "wsum"))
        ptrs = (ctypes.c_void_p * 28)(*(t.data_ptr() for t in arrays),
                                      *(t.data_ptr() for t in leaf),
                                      *(t.data_ptr() for t in stats))
        pack = (ptrs, ctypes.addressof(ptrs), leaf)
        tree._k6 = pack
    return pack


def write_nodes(tree: Tree, src: GameState, status: torch.Tensor,
                value: torch.Tensor, legal: torch.Tensor,
                probs: torch.Tensor, path: Descent | None = None):
    """Write one node per game into the tree, in place (kernel K6).

    ``status`` [B] is the game status of ``src`` and ``value`` [B] the
    network's value of it: the node's ``terminal`` is ``status !=
    NOT_ENDED`` and its value the terminal value when terminal, else
    ``value`` (``simulate_once:221-227``).  With ``path`` (one
    simulation's descent): a game is expanding when ``path.exp_n >= 0``
    and its root is not terminal.  Its node ``idx = min(next_free, N -
    1)`` receives the state ``src`` with its terminal flag, value,
    ``legal`` and ``probs``; its parent's child link and ``next_free``
    follow.  Other games write nothing.  Returns ``(leaf_v [B] f32,
    leaf_p [B] i32)``: the new node's value and mover when expanding, else
    those of ``path.cur``; on the card two buffers of the tree, rewritten
    by its next simulation.  Without ``path`` the same fields go to node 0
    of every game (the root write) and nothing is returned.

    CPU tensors take ``_write_nodes_plain``; CUDA tensors launch the kernel
    (no fallback).
    """
    if tree.visit.device.type == "cpu":
        return _write_nodes_plain(tree, src, status, value, legal, probs,
                                  path)
    b, n = tree.player.shape
    ck = rules.checked
    _, pack_addr, leaf = _k6_pack(tree)
    ins = (*rules.state_fields(src, (b,), _STATE_SPEC),
           ck(status, I32, (b,), "status"), ck(value, F32, (b,), "value"),
           ck(legal, torch.bool, (b, NUM_ACTIONS), "legal"),
           ck(probs, F32, (b, NUM_ACTIONS), "probs"))
    if path is None:
        idxs = (None,) * 4
    else:
        idxs = tuple(ck(t, I32, (b,), name).data_ptr() for name, t in (
            ("exp_n", path.exp_n), ("exp_a", path.exp_a),
            ("exp_o", path.exp_o), ("cur", path.cur)))
    if b:
        kernels.TREE_WRITE.launch(pack_addr, *(t.data_ptr() for t in ins),
                                  *idxs, b, n, int(path is None))
    return None if path is None else leaf


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


@functools.lru_cache(maxsize=None)
def _descend_tables(device: torch.device):
    """K2's constant inputs on ``device``: the outcome logits
    (``outcome_logp``) and NEIGHBOR_RANK as int8 [42, 42]."""
    nrank = torch.from_numpy(topology.NEIGHBOR_RANK.astype(np.int8))
    return outcome_logp(device), nrank.to(device)


def descend(tree: Tree, gumbel: torch.Tensor, cfg: Config) -> Descent:
    """One simulation's descent from each game's root (kernel K2).

    ``gumbel`` [max_depth, B, 3] f32 is the outcome noise of this
    simulation.  CPU tensors take ``_descend_plain``; CUDA tensors launch
    the kernel (no fallback).  On the card the outputs are views of two
    int32 buffers, [3, B, max_depth] paths and [5, B] ends."""
    if tree.visit.device.type == "cpu":
        return _descend_plain(tree, gumbel, cfg)
    b, n = tree.player.shape
    d_cap = cfg.max_depth
    st = tree.states
    ins = (tree.root, tree.terminal, tree.player, tree.legal, tree.prior,
           tree.visit, tree.wsum, tree.children, st.phase, st.army,
           st.owner, gumbel)
    kernels.require_cuda(*ins)
    if tuple(gumbel.shape) != (d_cap, b, 3) or gumbel.dtype != F32:
        raise ValueError("gumbel must be [max_depth, B, 3] float32")
    dev = gumbel.device
    paths = torch.empty((3, b, d_cap), dtype=I32, device=dev)
    ends = torch.empty((5, b), dtype=I32, device=dev)
    if b:
        kernels.MCTS_DESCEND.launch(
            *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in _descend_tables(dev)),
            1.0 - cfg.noise_eps, cfg.noise_eps * cfg.noise_value, cfg.cpuct,
            b, n, d_cap, paths.data_ptr(), ends.data_ptr())
    return Descent(*paths.unbind(0), *ends.unbind(0))


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


def _path_buffers(path: Descent, b: int, d: int):
    """K3's view of ``path``: its [3, B, D] path buffer (as the base of
    ``pn``, ``pa`` and ``pp``) and its depth, each checked.  A path from
    ``descend`` on the card is three rows of one K2 buffer, adjacent in
    memory, and is passed as it is; other path tensors are stacked into
    one buffer."""
    pn, pa, pp = (rules.checked(t, I32, (b, d), name) for name, t in
                  (("pn", path.pn), ("pa", path.pa), ("pp", path.pp)))
    depth = rules.checked(path.depth, I32, (b,), "depth")
    plane = 4 * b * d
    base = pn.data_ptr()
    if (pa.data_ptr(), pp.data_ptr()) == (base + plane, base + 2 * plane):
        return pn, depth
    return torch.stack((pn, pa, pp)), depth


def backup(tree: Tree, path: Descent, leaf_v: torch.Tensor,
           leaf_p: torch.Tensor) -> None:
    """Add one visit and the sign-flipped leaf value along each game's path
    (kernel K3), in place on ``tree.visit`` and ``tree.wsum``.  CPU tensors
    take ``_backup_plain``; CUDA tensors launch the kernel.  On the card
    the tree arrays and ``write_nodes``' leaf outputs come checked from the
    tree's pointer pack; other leaf tensors are checked here."""
    if tree.visit.device.type == "cpu":
        _backup_plain(tree, path, leaf_v, leaf_p)
        return
    b, n = tree.player.shape
    d = path.pn.shape[1]
    if d > MAX_DEPTH:
        raise ValueError(f"K3 takes paths of at most {MAX_DEPTH} edges, "
                         f"got {d}")
    _, pack_addr, leaf = _k6_pack(tree)
    paths, depth = _path_buffers(path, b, d)
    if leaf_v is leaf[0] and leaf_p is leaf[1]:
        lv = lp = None              # K3 reads them from the pack
    else:
        lv = rules.checked(leaf_v, F32, (b,), "leaf_v").data_ptr()
        lp = rules.checked(leaf_p, I32, (b,), "leaf_p").data_ptr()
    if b:
        kernels.MCTS_BACKUP.launch(pack_addr, paths.data_ptr(),
                                   depth.data_ptr(), lv, lp, b, n, d)


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


def reroot(tree: Tree, action: torch.Tensor, outcome: torch.Tensor,
           cfg: Config) -> Tuple[Tree, torch.Tensor]:
    """Advance each game's root through the edge actually played.

    The reference's ``trimNodes`` tree reuse (alphazero_mcts.cpp:229-245)
    on the node arrays: the subtree of the child under (``action``,
    ``outcome``), with its statistics, priors and leaf values, is compacted
    to the front of the arrays, in its original order, and becomes the
    next search's tree; every other node is dropped.  Membership comes
    from parent-pointer doubling, the compaction from a stable sort of the
    drop flags.  Returns ``(tree, reused [B] bool)``: a game whose played
    edge has no expanded child gets ``reused = False`` and a fresh tree in
    ``search_with_reuse``.

    The result is a new ``Tree`` of contiguous tensors with no kernel
    pointer pack: the next search packs it at its first write.  Plain
    tensor ops (once per decision); as JAX's ``reroot``, bit for bit.
    """
    b, n = tree.player.shape
    dev = tree.player.device
    rows = _rows(b, dev)
    c = tree.children[rows, tree.root.long(), action.long(), outcome.long()]
    has_child = c >= 0
    c_safe = c.clamp(min=0).long()

    # reachable from c through parent pointers: 2^k ancestors after k
    # doublings, enough for any path in an N-node tree
    idx = torch.arange(n, device=dev)[None, :]
    reach = idx == c_safe[:, None]
    anc = torch.where(tree.parent >= 0, tree.parent.long(), idx)
    for _ in range(max(7, (n - 1).bit_length())):
        reach = reach | torch.gather(reach, 1, anc)
        anc = torch.gather(anc, 1, anc)
    reach = reach & tree.expanded & has_child[:, None]

    # stable compaction: kept nodes first, in their original order
    order = torch.argsort((~reach).to(torch.int8), dim=1, stable=True)
    new_id_of_old = torch.empty_like(order).scatter_(
        1, order, idx.expand(b, n).contiguous())
    n_keep = reach.sum(-1)
    keep = idx < n_keep[:, None]
    grows = rows[:, None]

    def gather(x):
        return x[grows, order]

    def kept(x, fill):
        k = keep.reshape(keep.shape + (1,) * (x.dim() - 2))
        return torch.where(k, gather(x), fill)

    def remap_ids(ids):
        """Old node ids -> new ones; links to dropped nodes become -1."""
        safe = ids.clamp(min=0).long().reshape(b, -1)
        mapped = torch.gather(new_id_of_old, 1, safe).reshape(ids.shape)
        target_kept = torch.gather(reach, 1, safe).reshape(ids.shape)
        return torch.where((ids >= 0) & target_kept, mapped, -1).to(I32)

    parent = remap_ids(gather(tree.parent))
    parent = torch.where(keep, parent, -1)
    children = remap_ids(gather(tree.children))
    children = torch.where(keep[:, :, None, None], children, -1)
    root = torch.where(has_child, new_id_of_old[rows, c_safe], 0)
    parent[rows, root] = -1               # the new root has no parent
    out = Tree(
        states=tree_map(gather, tree.states),
        expanded=kept(tree.expanded, False),
        terminal=kept(tree.terminal, False),
        value=gather(tree.value), player=gather(tree.player),
        parent=parent, legal=kept(tree.legal, False),
        prior=kept(tree.prior, 0.0), visit=kept(tree.visit, 0),
        wsum=kept(tree.wsum, 0.0), children=children,
        next_free=n_keep.to(I32), root=root.to(I32))
    return out, has_child


def _select_tree(pred: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Per game, ``a``'s arrays where ``pred`` else ``b``'s, as a new
    ``Tree`` of fresh tensors."""
    def sel(x, y):
        p = pred.reshape(pred.shape + (1,) * (x.dim() - 1))
        return torch.where(p, x, y)

    return Tree(**{
        f.name: (tree_map(sel, getattr(a, f.name), getattr(b, f.name))
                 if f.name == "states" else
                 sel(getattr(a, f.name), getattr(b, f.name)))
        for f in dataclasses.fields(Tree)})


def carried_roots_match(prev_tree: Tree, root: GameState) -> torch.Tensor:
    """[B] bool: the carried tree's root state equals ``root`` in every
    field (the reference reuses only exact transposition-table hits,
    alphazero_mcts.cpp:229-245; a partial check would search a tree whose
    cards or mobilization context diverged)."""
    rows = _rows(root.batch_size, root.device)
    r = prev_tree.root.long()
    same = torch.ones((root.batch_size,), dtype=torch.bool,
                      device=root.device)
    for f in dataclasses.fields(GameState):
        carried = getattr(prev_tree.states, f.name)[rows, r]
        d = carried == getattr(root, f.name)
        same &= d.reshape(d.shape[0], -1).all(-1)
    return same


def search_with_reuse(root: GameState, gumbel: torch.Tensor, cfg: Config,
                      eval_fn: EvalFn, prev_tree: Tree | None,
                      reused: torch.Tensor | None,
                      noise_u: torch.Tensor | None = None) -> SearchResult:
    """``search`` from a rerooted tree (``reroot``): games with
    ``~reused``, or whose carried root state is stale in any field, start
    from a fresh tree.  ``prev_tree=None`` means no game reuses (the first
    decision of a chunk), and the search is ``search``'s."""
    rules.require_uniform(cfg, None)
    tree = init_tree(root, cfg, eval_fn)
    if prev_tree is not None:
        same = reused & carried_roots_match(prev_tree, root)
        tree = _select_tree(same, prev_tree, tree)
    return _run_search(tree, gumbel, cfg, eval_fn, noise_u)


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
