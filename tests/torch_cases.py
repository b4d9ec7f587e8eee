"""Cases shared by the port's card tests, its CPU tests and
``tools/time_kernels.py``: crafted search trees, mixed and full-cards
states of play, a stand-in network, the plain versions swapped in for the
kernels, and the per-iteration match loop the block loop replaces.

Imports torch and the port only, never JAX, so that it serves the card
tests (run without the repo's conftest) and the timing tool on a machine
without JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from alphazero_risk_tpu_torch.config import PH_ATTACK

MIXED = 1024        # states of ``mixed_states`` and ``card_states``


def random_play_states(batch, steps, gen, cfg, dev):
    """States reached by ``steps`` lockstep steps of random legal play from
    ``batch`` fresh deals, in all phases."""
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import new_game
    st = new_game(batch, generator=gen, device=dev)
    for _ in range(steps):
        legal = rules.legal_actions(st, cfg)
        g = torch.rand(legal.shape, generator=gen, device=dev)
        a = torch.argmax(torch.where(legal, g, -1.0), dim=-1).to(torch.int32)
        st = rules.step_key(st, a, gen, cfg)
    return st


def heuristic_eval(state, legal):
    """Uniform prior + army/land-share value: a cheap stand-in network."""
    probs = legal.float() / legal.sum(-1, keepdim=True).clamp(min=1)
    own = state.owner == state.cur_player[:, None]
    en = state.owner == (1 - state.cur_player)[:, None]
    ta, ea = (state.army * own).sum(-1), (state.army * en).sum(-1)
    lo, le = own.sum(-1), en.sum(-1)
    v = 0.5 * (ta - ea) / (ta + ea).clamp(min=1) + 0.5 * (lo - le) / 42.0
    return probs, v.to(torch.float32)


def clone_tree(tree):
    """A copy of ``tree`` whose every array is its own."""
    from alphazero_risk_tpu_torch.env.state import GameState, tree_map
    return type(tree)(**{
        f.name: (tree_map(torch.clone, getattr(tree, f.name))
                 if isinstance(getattr(tree, f.name), GameState)
                 else getattr(tree, f.name).clone())
        for f in dataclasses.fields(tree)})


TIE_CASES = ("fresh_ties", "no_legal", "equal_armies", "no_source")


def tie_tree(tree, case):
    """A copy of ``tree`` rewritten so that K2's warp reductions meet
    ties: ``fresh_ties`` zeroes visits and values and spreads each row's
    prior evenly over its legal actions (every legal action ties in U, the
    first wins); ``no_legal`` also clears every legal row of the odd games
    (index 0 wins); ``equal_armies`` and ``no_source`` also put every node
    in the attack phase with 3 armies (the attack sources tie in army, the
    neighbour rank decides) or 1 army (no source: every land ties at -1)
    on every land."""
    t = clone_tree(tree)
    t.visit.zero_()
    t.wsum.zero_()
    legal = t.legal.to(torch.float32)
    t.prior.copy_(legal / legal.sum(-1, keepdim=True).clamp(min=1))
    if case == "no_legal":
        t.legal[1::2] = False
    elif case in ("equal_armies", "no_source"):
        t.states.phase.fill_(PH_ATTACK)
        t.states.army.fill_(3 if case == "equal_armies" else 1)
    return t


def first(mx, n):
    """The first ``n`` games of the mixed states ``mx``, as contiguous
    copies."""
    return mx.apply(lambda x: x[:n].contiguous())


def mixed_states(cfg, dev):
    """MIXED states drawn from every step of 128 games of mixed play
    (``driver.mixed_play``, 600 steps), each with its step's script carry,
    previous mover, draws and a random legal action.  The pick keeps the
    states whose random action is a fortify move with a tie the DFS breaks
    (up to 160), with a full land (96) and terminal (96), and fills the
    rest evenly over the six phases; the order is shuffled, so every prefix
    is a mix.  Raises unless every case is there."""
    from alphazero_risk_tpu_torch.agents.driver import mixed_play
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import tree_map

    gen = torch.Generator(device=dev).manual_seed(12)
    pool = mixed_play(128, 600, cfg, gen)
    allst = pool.state
    n = allst.batch_size
    ties = torch.cat([rules.fortify_needs_rank(
        tree_map(lambda x: x[i:i + 8192], allst), pool.action[i:i + 8192],
        cfg) for i in range(0, n, 8192)])
    full = (allst.army >= cfg.land_army_max).any(-1)
    ended = rules._game_status_plain(allst, cfg) != -1
    key = torch.rand(n, generator=gen, device=dev)
    chosen = torch.zeros(n, dtype=torch.bool, device=dev)
    for flag, k in ((ties, 160), (full, 96), (ended, 96)):
        pick = torch.where(flag & ~chosen, key, 2.0).argsort()[:k]
        chosen[pick[flag[pick]]] = True
    live = ~ended
    for ph in range(6):
        want = (MIXED - int(chosen.sum())) // (6 - ph)
        flag = live & (allst.phase == ph) & ~chosen
        pick = torch.where(flag, key, 2.0).argsort()[:want]
        chosen[pick[flag[pick]]] = True
    idx = chosen.nonzero().ravel()
    idx = idx[torch.randperm(idx.numel(), generator=gen, device=dev)]
    mx = pool.apply(lambda x: x[idx].contiguous())
    st = mx.state
    phases = torch.bincount(st.phase.long(), minlength=6).tolist()
    if st.batch_size != MIXED or min(phases) == 0 or not (
            bool((rules._game_status_plain(st, cfg) != -1).any())
            and bool((st.army >= cfg.land_army_max).any())
            and bool(rules.fortify_needs_rank(st, mx.action, cfg).any())):
        raise RuntimeError(f"the mixed states do not cover every case: "
                           f"{st.batch_size} states, per phase {phases}")
    return mx


def card_states(cfg, dev):
    """MIXED full-cards states: ``mixed_states`` under ``cfg`` (full
    cards), then three games in eight with their card fields dealt anew by
    ``driver.force_card_cases`` (hands of 0-12 cards, piles empty, nearly
    empty or full, bonus lands at land_army_max - 1 and - 2), one of those
    three moved to the reinforcement phase (the trade) and one to the
    fortify phase (the draw)."""
    import numpy as np
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.config import PH_FORTIFY, PH_REINFORCEMENT
    from alphazero_risk_tpu_torch.env.state import tree_select
    mx = mixed_states(cfg, dev)
    st = mx.state
    slot = torch.arange(st.batch_size, device=dev) % 8
    forced = D.force_card_cases(st, np.random.default_rng(5), cfg)
    forced = forced.replace(phase=torch.where(
        slot == 1, PH_REINFORCEMENT,
        torch.where(slot == 2, PH_FORTIFY, forced.phase)).to(torch.int32))
    return mx._replace(state=tree_select(slot < 3, forced, st))


@contextlib.contextmanager
def plain_versions():
    """Inside the block the agents' single steps (K9, K10), the rules
    (K7's step, step_with_outcome and expand; K8's views, and with them
    legality, status and features) and the search's node write, descent
    and backup (K6, K2, K3) run their plain versions on the card: what the
    kernels are held against over a whole ``run_scripted_episodes`` chunk
    and a whole game of the viewer.  (The folded network's K1, K4, K5 and
    the multi-step entry keep their kernels.)"""
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.mcts import search as S

    def state_views(st, cfg, *, legal=False, status=False, features=False):
        return rules._state_views_plain(st, cfg, legal, status, features)

    def write_nodes(tree, src, status, value, legal, probs, path=None):
        return S._write_nodes_plain(tree, src, status, value, legal, probs,
                                    path)

    swaps = [(SA, "script_step_recorded", SA._script_step_recorded_plain),
             (RA, "random_step_recorded", RA._random_step_recorded_plain),
             (rules, "game_status", rules._game_status_plain),
             (rules, "legal_actions", rules._legal_actions_plain),
             (rules, "state_views", state_views),
             (rules, "step", rules._step_plain),
             (rules, "step_with_outcome", rules._step_with_outcome_plain),
             (rules, "expand", rules._expand_plain),
             (S, "descend", S._descend_plain),
             (S, "backup", S._backup_plain),
             (S, "write_nodes", write_nodes)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def match_by_iteration(gen, state, agents, cfg, max_steps):
    """The per-iteration ``play_match`` loop the blocks replace, on the
    plain versions: every iteration draws, both seats' agents step every
    game, each game keeps its mover's state and carry, and the status
    check at the top of each iteration syncs once and counts the live
    micro-steps.  Returns (final state, steps, live micro-steps)."""
    from alphazero_risk_tpu_torch.agents import driver as D
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.agents.common import draw_step_randoms
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import tree_select
    b, dev = state.batch_size, state.phase.device
    carry = SA.init_carry(b, dev)
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)

    def agent_step(kind, state, carry, reset, u, dice):
        if kind == D.AGENT_SCRIPT:
            return SA._script_step_recorded_plain(state, carry, reset, u,
                                                  dice, cfg)[:2]
        return RA._random_step_recorded_plain(state, u, dice, cfg)[0], carry

    t = live = 0
    while t < max_steps:
        alive = int((rules._game_status_plain(state, cfg) == -1).sum())
        if not alive:
            break
        live += alive
        u, dice = draw_step_randoms(gen, b, dev)
        reset = state.cur_player != prev
        s0, c0 = agent_step(agents[0], state, carry, reset, u, dice)
        s1, c1 = (s0, c0) if agents[1] == agents[0] else agent_step(
            agents[1], state, carry, reset, u, dice)
        mover0 = state.cur_player == 0
        prev = state.cur_player
        state = tree_select(mover0, s0, s1)
        carry = tree_select(mover0, c0, c1)
        t += 1
    return state, t, live


def watch_launches(steps, sims, opponent):
    """The launches ``steps`` micro-steps of the AlphaZero viewer imply:
    every step searches (``record_all``, or the paired eval): K8 for the
    step's status, the root's legality and status, the root's and each
    simulation's features and the chunk's closing status; K6 for the root
    and each simulation; K2, K7's expand and K3 per simulation, K7 for the
    move; the opponent's single step (K9 or K10) once a step.  The plain
    network launches no K1, K4 (in either design) or K5."""
    return {"mcts_descend": steps * sims, "mcts_backup": steps * sims,
            "write_nodes": steps * (sims + 1),
            "rules_step": steps * (sims + 1),
            "state_views": steps * (sims + 4) + 1,
            "script_step": steps if opponent == "sp" else 0,
            "random_step": steps if opponent == "rp" else 0,
            "conv3x3_i8": 0, "conv3x3_bf16": 0, "heads_eval": 0,
            "agent_steps": 0, "stem_bf16": 0}
