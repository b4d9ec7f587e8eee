"""The plain reference of the play cells: the deal, one AlphaZero micro-step
(network, search, move pick, rules step, record) and the opponent's
fast-forward, each from the program's own state at a sampled micro-step.

Every function takes plain tensors that the benchmark captured and returns
counts of rows that differ, or gaps, so the caller holds each beside its
limit.
"""

from __future__ import annotations

import dataclasses

import torch

from .agents import blocks
from .agents.script_agent import ScriptCarry
from .config import STATUS_NOT_ENDED, Config
from .env import rules
from .env.state import GameState, invert_players, new_game, tree_map
from .mcts import search as mcts
from .models import fast_infer

F16, F32 = torch.float16, torch.float32


def mirrored_deal(batch: int, generator: torch.Generator) -> GameState:
    """B games as B/2 deals, each played from both sides."""
    half = new_game(batch // 2, generator=generator, device=generator.device)
    mirrored = invert_players(half).replace(
        cur_player=torch.ones_like(half.cur_player))
    return tree_map(lambda a, b: torch.cat([a, b]), half, mirrored)


def rows_differ(a: GameState, b: GameState) -> torch.Tensor:
    """[B] bool: the games whose state differs in any field."""
    out = None
    for f in dataclasses.fields(GameState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        d = (x.to(y.device) != y)
        d = d.reshape(d.shape[0], -1).any(-1) if d.dim() > 1 else d
        out = d if out is None else out | d
    return out


def as_state(fields: dict, device) -> GameState:
    return GameState(**{k: v.to(device) for k, v in fields.items()})


def state_fields(state) -> dict:
    """The fields of any GameState-like dataclass, cloned."""
    return {f.name: getattr(state, f.name).detach().clone()
            for f in dataclasses.fields(state)}


def record(state: GameState, pi: torch.Tensor, valid: torch.Tensor) -> dict:
    """The compact training record of one micro-step."""
    return {
        "owner": state.owner.to(torch.int8),
        "army": state.army.to(torch.int8),
        "cur_player": state.cur_player.to(torch.int8),
        "phase": state.phase.to(torch.int8),
        "round": state.round.to(torch.int16),
        "reinforcements": state.reinforcements.to(torch.int16),
        "attacks_during_turn": state.attacks_during_turn.to(torch.int16),
        "can_draw_card": state.can_draw_card,
        "policy": pi.to(F16),
        "valid": valid,
    }


def records_differ(prog: dict, ref: dict) -> torch.Tensor:
    out = None
    for k, v in ref.items():
        d = prog[k].to(v.device) != v
        d = d.reshape(d.shape[0], -1).any(-1) if d.dim() > 1 else d
        out = d if out is None else out | d
    return out


def live_rows(state: GameState, cfg: Config) -> torch.Tensor:
    return rules.game_status(state, cfg) == STATUS_NOT_ENDED


def search_root(cap: dict, folded: dict, cfg: Config):
    """The reference's search of the captured root state with the
    captured chance noise: ``(result, root prior, root value)``."""
    dev = cap["gumbel"].device
    state = as_state(cap["state"], dev)
    efn = fast_infer.make_eval_fn(folded, cfg)
    res = mcts.search(state, cap["gumbel"], cfg, efn)
    rows = torch.arange(state.batch_size, device=dev)
    root = res.tree.root.long()
    return res, res.tree.prior[rows, root], res.tree.value[rows, root]


def control_outputs(cap: dict, folded: dict, cfg: Config) -> dict:
    """``cap`` with the program's root prior, value and visit counts
    replaced by another network's (the control's)."""
    res, prior, value = search_root(cap, folded, cfg)
    return {**cap, "prior": prior, "value": value,
            "visits": res.visit_counts}


def check_step(cap: dict, folded: dict, cfg: Config) -> dict:
    """Hold one captured micro-step of the program against the reference.

    ``cap`` holds the root state's fields, the search's chance noise, the
    program's root prior, root value and visit counts, the move it picked
    (with the sampling noise, or None), the dice and the state its rules
    step gave.  Returns ``net_gap_max`` (widest gap of a root prior or value
    over live games), ``net_gap_p99`` (its 99th percentile over the live
    games), ``visit_gap`` (mean total-variation distance of the
    root visit shares over live games), and the numbers of games whose
    picked move or stepped state differ."""
    dev = cap["gumbel"].device
    state = as_state(cap["state"], dev)
    live = live_rows(state, cfg)
    res, prior, value = search_root(cap, folded, cfg)
    gap_p = (cap["prior"].to(dev) - prior).abs().amax(-1)
    gap_v = (cap["value"].to(dev) - value).abs()
    row_gap = torch.maximum(gap_p, gap_v)[live]
    net_gap = row_gap.amax() if row_gap.numel() else torch.zeros(())
    net_p99 = (torch.quantile(row_gap, 0.99) if row_gap.numel()
               else torch.zeros(()))
    pi_p = cap["visits"].to(dev, F32)
    pi_p = pi_p / pi_p.sum(-1, keepdim=True).clamp(min=1e-9)
    tv = 0.5 * (pi_p - res.pi).abs().sum(-1)
    n_live = int(live.sum())
    visit_gap = float(torch.where(live, tv, 0.0).sum()) / max(n_live, 1)
    # the move and the step, from the program's own visit counts
    prog_res = res._replace(visit_counts=cap["visits"].to(dev), pi=pi_p)
    sample = cap["pick_noise"] is not None
    action = mcts.pick_move(prog_res, state, cfg, sample,
                            cap["pick_noise"] if sample else None)
    pick_bad = int((action.to(torch.int32)
                    != cap["action"].to(dev, torch.int32)).sum())
    stepped = rules.step(state, cap["action"].to(dev), cap["dice"].to(dev),
                         cfg)
    step_bad = int(rows_differ(stepped, as_state(cap["next"], dev)).sum())
    out = {"net_gap_max": float(net_gap), "net_gap_p99": float(net_p99),
           "visit_gap": visit_gap,
           "pick_mismatch": pick_bad, "rules_mismatch": step_bad,
           "live": n_live}
    if cap.get("record") is not None:
        ref = record(state, pi_p, live)
        out["record_mismatch"] = int(records_differ(cap["record"], ref).sum())
    return out


def check_fast_forward(cap: dict, cfg: Config, kinds) -> int:
    """Games whose fast-forward differs: the reference's agents step the
    captured state with the draws the program's blocks were handed, in
    order."""
    dev = cap["blocks"][0][0].device
    state = as_state(cap["state"], dev)
    carry = ScriptCarry(*(t.to(dev) for t in cap["carry"]))
    handed = list(cap["blocks"])

    def block(k):
        if not handed:
            raise RuntimeError("the reference asked for more draws than the "
                               "program took")
        u, dice = handed.pop(0)
        if u.shape[0] != k:
            raise RuntimeError("the reference asked for another block size")
        return u, dice

    st, carry2, prev, _, _ = blocks.run_agent_blocks(
        state, carry, cap["prev"].to(dev), cfg, block, lambda m: None,
        kinds=kinds, k=cap["k"], k_max=cap["k_max"])
    bad = rows_differ(st, as_state(cap["out_state"], dev))
    bad |= prev.to(torch.int32) != cap["out_prev"].to(dev, torch.int32)
    for name, y in zip(("attack_to", "attack_from", "mode_b"),
                       cap["out_carry"]):
        bad |= getattr(carry2, name) != y.to(dev)
    return int(bad.sum())


def check_deal(batch: int, gen_state: torch.Tensor, device,
               prog_fields: dict) -> int:
    """Games whose deal differs from the reference's from the same
    generator state."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    ref = mirrored_deal(batch, g)
    return int(rows_differ(ref, as_state(prog_fields, device)).sum())
