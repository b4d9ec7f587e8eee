"""Self-play / evaluation actors driving MCTS over batched games.

Port of ``alphazero_risk_tpu/training/actor.py``: every micro-move, one
batched MCTS over all B games produces policies; games whose mover is a
scripted or random opponent step with their own policy instead.  When
opponent records are not needed, opponent movers are fast-forwarded to
their next AlphaZero turn before each search.

Sample records are compact state snapshots (not expanded feature images):
the replay buffer stores what ``NNInputData`` stores in the reference
(alphazero_nn_data.h:70-96) and features are rebuilt at training time.

Randomness is explicit.  ``run_episodes`` takes a ``draws`` object that
hands out, per step, the search's Gumbel noise and root-noise uniforms, the
Gumbel noise of a sampled move, the dice of the AlphaZero move and the
opponent's ``u``/dice (of the step, and of the fast-forward's iterations
in blocks that can be put back, ``ff_block(k)`` and ``ff_rewind(m)``).
``GeneratorDraws`` draws them from a ``torch.Generator``; a test can hand in
the numbers another implementation drew.  In a process world
``WorldDraws`` draws the world's global tensors and keeps this rank's rows,
so every rank's generator stays in step and each game sees the numbers it
would see in one process.  ``run_scripted_episodes`` (the
supervised-bootstrap generator: scripted and random agents only, every
decision recorded) takes one ``opp()`` draw per step from the same kind of
object.

With ``cfg.tree_reuse`` the single-net paths (self-play and versus) carry
each search's tree to the next decision: the move's realised battle outcome
reroots it (``mcts.reroot``) and ``mcts.search_with_reuse`` continues from
it wherever the carried root still equals the game's state.  Trees are
carried within a ``run_episodes`` call and start fresh in each chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..agents import blocks, random_agent, script_agent
from ..agents.blocks import OPP_AZ, OPP_RANDOM, OPP_SCRIPT
from ..agents.common import BlockDraws, draw_step_randoms
from ..config import (Config, NUM_ACTIONS, NUM_LANDS, PH_ATTACK, SKIP_ACTION,
                      STATUS_NOT_ENDED)
from ..env import rules
from ..env.featurize import featurize
from ..env.state import GameState, tree_select
from ..mcts import search as mcts
from ..models.resnet import AZNet
from ..parallel import distributed as D
from ..utils import profiling

# The opponent fast-forward's blocks of draws: the first of FF_BLOCK
# iterations, each next one twice the last, at most FF_BLOCK_MAX.  In the
# 32-game play slice 156 of 256 fast-forwards run no iteration, the rest
# 2 to 90 (median 27), so most take one block, 38 of them two.  A first
# block sized from the previous fast-forward was not faster beyond the
# runs' spread on an H100.
FF_BLOCK, FF_BLOCK_MAX = 32, 64

I8, I16, I32 = torch.int8, torch.int16, torch.int32
F16, F32 = torch.float16, torch.float32


class SampleBatch(NamedTuple):
    """Compact per-micro-decision training record ([T, B, ...] stacked)."""

    owner: torch.Tensor            # int8 [.., 42]
    army: torch.Tensor             # int8 [.., 42]
    cur_player: torch.Tensor       # int8
    phase: torch.Tensor            # int8
    round: torch.Tensor            # int16
    reinforcements: torch.Tensor   # int16
    attacks_during_turn: torch.Tensor  # int16
    can_draw_card: torch.Tensor    # bool
    policy: torch.Tensor           # float16 [.., 43] (MCTS visit shares
    #                                need ~10 bits)
    value: torch.Tensor            # float32 (z, filled after game end)
    valid: torch.Tensor            # bool: mover was recording and game live


def state_of_samples(s: SampleBatch, cfg: Config) -> GameState:
    """Rebuild a GameState (for featurize) from flat sample records."""
    n, dev = s.owner.shape[0], s.owner.device
    z = torch.zeros((n,), dtype=I32, device=dev)
    return GameState(
        owner=s.owner.to(I32),
        army=s.army.to(I32),
        phase=s.phase.to(I32),
        round=s.round.to(I32),
        cur_player=s.cur_player.to(I32),
        reinforcements=s.reinforcements.to(I32),
        cards=torch.zeros((n, 2), dtype=I32, device=dev),
        card_sets_played=z,
        mob_from=z - 1,
        mob_to=z - 1,
        can_draw_card=s.can_draw_card,
        attacks_during_turn=s.attacks_during_turn.to(I32),
        player_cards=torch.zeros((n, 2, NUM_LANDS), dtype=torch.bool,
                                 device=dev),
        drawn_cards=torch.zeros((n, NUM_LANDS), dtype=torch.bool,
                                device=dev),
    )


def features_of_samples(s: SampleBatch, cfg: Config) -> torch.Tensor:
    return featurize(state_of_samples(s, cfg), cfg)


def prepare_samples(data, idx, cfg: Config):
    """The learner's minibatch ``{features, policy, value}`` from compact
    sample rows ``data[k][idx]`` (``idx`` None: every row).  The policy
    travels float16 (``_record``, ``replay.FIELDS``); the loss takes it in
    float32."""
    sub = data if idx is None else {k: v[idx] for k, v in data.items()}
    sb = SampleBatch(valid=None, **sub)
    return {"features": features_of_samples(sb, cfg),
            "policy": sub["policy"].to(F32),
            "value": sub["value"]}


def _record(state: GameState, pi: torch.Tensor,
            valid: torch.Tensor) -> SampleBatch:
    return SampleBatch(
        owner=state.owner.to(I8),
        army=state.army.to(I8),
        cur_player=state.cur_player.to(I8),
        phase=state.phase.to(I8),
        round=state.round.to(I16),
        reinforcements=state.reinforcements.to(I16),
        attacks_during_turn=state.attacks_during_turn.to(I16),
        can_draw_card=state.can_draw_card,
        policy=pi.to(F16),
        value=torch.zeros((state.batch_size,), dtype=F32,
                          device=state.device),
        valid=valid,
    )


def _masked_softmax(logits: torch.Tensor, legal: torch.Tensor):
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    return torch.softmax(torch.where(legal, logits, neg_inf), dim=-1)


def make_eval_fn(net: AZNet, cfg: Config):
    """eval_fn(state, legal) -> (probs, value) over the plain network."""

    @torch.no_grad()
    def eval_fn(state: GameState, legal: torch.Tensor):
        logits, value = net(featurize(state, cfg))
        return _masked_softmax(logits, legal), value

    return eval_fn


def make_paired_eval_fn(net_a: AZNet, net_b: AZNet, cfg: Config):
    """eval_fn(state, legal, use_a) evaluating two plain networks, selected
    per game: one shared tree search serves an arena of model A vs model B
    (the reference runs one network per player group instead,
    alphazero_gpu_cluster.cpp:105-160)."""

    @torch.no_grad()
    def eval_fn(state: GameState, legal: torch.Tensor, use_a: torch.Tensor):
        feats = featurize(state, cfg)
        la, va = net_a(feats)
        lb, vb = net_b(feats)
        logits = torch.where(use_a[:, None], la, lb)
        return _masked_softmax(logits, legal), torch.where(use_a, va, vb)

    return eval_fn


class GeneratorDraws:
    """The random draws of ``run_episodes``, from one generator."""

    def __init__(self, generator: torch.Generator, cfg: Config,
                 batch: int, device):
        self.gen, self.cfg, self.batch, self.device = (generator, cfg, batch,
                                                       device)
        self._ff = BlockDraws(generator, batch, device)

    def begin_step(self) -> None:
        """Called once at the start of every micro-step."""

    def ff_block(self, k: int):
        """(u [k,B,4], dice [k,B,5]): the next k fast-forward iterations'
        draws, each as ``opp()`` draws it."""
        return self._ff.block(k)

    def ff_rewind(self, m: int) -> None:
        """Put the draws back to after the last block's first m."""
        self._ff.rewind(m)

    def gumbel(self) -> torch.Tensor:
        """[S, max_depth, B, 3] chance noise of the step's search."""
        return mcts.draw_gumbel(self.gen, self.cfg, self.batch, self.device)

    def root_noise(self) -> torch.Tensor:
        """[B, 43] uniforms of the search's root Dirichlet noise."""
        return mcts.draw_noise_uniform(self.gen, self.batch, self.device)

    def pick(self) -> torch.Tensor:
        """[B, 43] Gumbel noise of the sampled move choice."""
        u = torch.rand((self.batch, NUM_ACTIONS), generator=self.gen,
                       device=self.gen.device)
        u = u.clamp(min=torch.finfo(F32).tiny)
        return (-torch.log(-torch.log(u))).to(self.device)

    def az_dice(self) -> torch.Tensor:
        """[B, 5] dice of the AlphaZero move."""
        return rules.roll_dice(self.gen, self.batch).to(self.device)

    def opp(self):
        """(u [B,4], dice [B,5]) of the step's opponent move."""
        return draw_step_randoms(self.gen, self.batch, self.device)


class WorldDraws(GeneratorDraws):
    """``GeneratorDraws`` of a process world: every draw is the global
    batch's (``batch * world`` games), as in JAX, where a chunk is one
    global dispatch, and this rank keeps its rows ``[r * batch, (r + 1) *
    batch)`` (dim 0; dim 1 of a fast-forward block, dim 2 of ``gumbel``).

    The fast-forward runs a data-dependent number of iterations: ``while
    some game moves``, which in JAX is a world-wide condition.
    ``ff_agree`` takes the world's maximum of this rank's iterations (one
    all-reduce) and advances the draws by the iterations the other ranks
    ran beyond this one's."""

    def __init__(self, generator: torch.Generator, cfg: Config,
                 batch: int, device):
        super().__init__(generator, cfg, batch * D.world(), device)
        self.rows = slice(D.rank() * batch, (D.rank() + 1) * batch)

    def _mine(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        # a copy: contiguous and aligned, as the kernels take their inputs
        idx = (slice(None),) * dim + (self.rows,)
        return x[idx].clone(memory_format=torch.contiguous_format)

    def ff_block(self, k: int):
        u, dice = super().ff_block(k)
        return self._mine(u, 1), self._mine(dice, 1)

    def ff_agree(self, iterations: int) -> None:
        behind = D.allgather_max(iterations) - iterations
        if behind > 0:
            super().ff_block(behind)

    def gumbel(self) -> torch.Tensor:
        return self._mine(super().gumbel(), 2)

    def root_noise(self) -> torch.Tensor:
        return self._mine(super().root_noise())

    def pick(self) -> torch.Tensor:
        return self._mine(super().pick())

    def az_dice(self) -> torch.Tensor:
        return self._mine(super().az_dice())

    def opp(self):
        u, dice = super().opp()
        return self._mine(u), self._mine(dice)


class ActorOutput(NamedTuple):
    state: GameState
    samples: SampleBatch            # [T, B, ...]
    status: torch.Tensor            # [B]
    carry: script_agent.ScriptCarry  # opponent carry (chunking)
    prev_player: torch.Tensor       # mover of last step
    az_decisions: torch.Tensor      # 0-d: searches made for live AZ movers


def _opponent_step(kind: int, state, carry, reset, u, dice, cfg):
    """Returns (state, carry, (action43, record_mask))."""
    if kind == OPP_SCRIPT:
        return script_agent.script_step_recorded(state, carry, reset, u,
                                                 dice, cfg)
    if kind == OPP_RANDOM:
        s, info = random_agent.random_step_recorded(state, u, dice, cfg)
        return s, carry, info
    raise ValueError(kind)


def run_episodes(eval_fn, state0: GameState, draws, cfg: Config,
                 num_steps: int, opponent: int = OPP_AZ,
                 az_seats: Tuple[bool, bool] = (True, True),
                 sample_moves: bool = True, record_all: bool = True,
                 paired_eval: bool = False,
                 carry_in=None, prev_in=None) -> ActorOutput:
    """Advance B games ``num_steps`` micro-decisions.

    ``carry_in``/``prev_in`` resume a chunked run (the trainer drives
    episodes in bounded chunks and stops when every game has ended).

    ``eval_fn(state, legal) -> (probs, value)`` is closed over the weights.
    ``az_seats[p]``: seat p is MCTS-driven; other seats use ``opponent``.
    ``sample_moves``: temperature-threshold sampling (training) vs argmax
    (evaluation), reference alphazero_trainer.cpp:99-106.
    ``record_all``: record opponent micro-decisions too (one-hot policy),
    like reference ``Player::addTrainingSample`` (player.cpp:9-17).
    ``paired_eval``: ``eval_fn(state, legal, use_a)`` with use_a = the
    *root* mover is seat 0; each seat's MCTS evaluates every leaf with its
    own network, as in the reference arena.

    When opponent records are not needed (``record_all=False``), opponent
    movers are fast-forwarded to their next AZ turn before each search, so
    no MCTS compute is spent on games an opponent is moving in.  The
    opponent fast-forwards in blocks of draws (``blocks.run_agent_blocks``,
    blocks of ``FF_BLOCK`` to ``FF_BLOCK_MAX`` iterations; on the card one
    launch of the multi-step entry and one host sync per block).  A draws
    object with an ``ff_agree`` method (``WorldDraws``) is then given the
    fast-forward's iterations, to agree on them with the other ranks.
    Under the profiler (``utils.profiling``) each micro-step is an
    ``actor.step`` span.
    """
    # the search expands by step_with_outcome, which has no card uniform
    rules.require_uniform(cfg, None)
    b, dev = state0.batch_size, state0.device
    both_az = az_seats[0] and az_seats[1]
    fast_forward = not both_az and not record_all
    if fast_forward and opponent not in (OPP_SCRIPT, OPP_RANDOM):
        raise ValueError(opponent)
    ff_kinds = tuple(OPP_AZ if az else opponent for az in az_seats)
    # tree reuse on the single-net paths: the arena's two seats would need
    # two trees.  No tree is carried into a chunk's first decision.
    reuse = cfg.tree_reuse and not paired_eval
    tree_prev, reused_prev = None, None
    state = state0
    carry = script_agent.init_carry(b, dev) if carry_in is None else carry_in
    prev = (torch.full((b,), -1, dtype=I32, device=dev)
            if prev_in is None else prev_in)
    decisions = torch.zeros((), dtype=torch.int64, device=dev)
    records = []

    def az_mask_of(st):
        return torch.where(st.cur_player == 0, az_seats[0], az_seats[1])

    ff_agree = getattr(draws, "ff_agree", None)

    for _ in range(num_steps):
        with profiling.span("actor.step"):
            draws.begin_step()
            if fast_forward:
                state, carry, prev, ff_iters, _ = blocks.run_agent_blocks(
                    state, carry, prev, cfg, draws.ff_block, draws.ff_rewind,
                    kinds=ff_kinds, k=FF_BLOCK, k_max=FF_BLOCK_MAX)
                if ff_agree is not None:
                    ff_agree(ff_iters)

            live = rules.game_status(state, cfg) == STATUS_NOT_ENDED
            mover = state.cur_player
            az_mask = az_mask_of(state)

            # --- AZ path: batched MCTS + visit-count policy ---
            if paired_eval:
                use_a = mover == 0
                efn = lambda s, m: eval_fn(s, m, use_a)  # noqa: E731
            else:
                efn = eval_fn
            noise_u = draws.root_noise() if cfg.use_dirichlet_noise else None
            if reuse:
                res = mcts.search_with_reuse(state, draws.gumbel(), cfg, efn,
                                             tree_prev, reused_prev,
                                             noise_u=noise_u)
            else:
                res = mcts.search(state, draws.gumbel(), cfg, efn,
                                  noise_u=noise_u)
            action = mcts.pick_move(res, state, cfg, sample_moves,
                                    draws.pick() if sample_moves else None)
            dice = draws.az_dice()
            s_az = rules.step(state, action, dice, cfg)
            if reuse:
                tree_prev, reused_prev = mcts.reroot(
                    res.tree, action, realised_outcome(state, action, dice),
                    cfg)

            # --- opponent path ---
            if both_az or fast_forward:
                # after the fast-forward every live game is at an AZ turn, so
                # the opponent's step would never be selected
                nstate, n_carry = s_az, carry
                pi = res.pi
                rec_valid = live & az_mask
            else:
                reset = state.cur_player != prev
                u, dice = draws.opp()
                s_opp, n_carry, (opp_action, opp_rec) = _opponent_step(
                    opponent, state, carry, reset, u, dice, cfg)
                nstate = tree_select(az_mask, s_az, s_opp)
                n_carry = tree_select(az_mask | ~live, carry, n_carry)
                # AZ movers contribute the MCTS pi; opponents one-hot actions
                opp_pi = F.one_hot(opp_action.long(), NUM_ACTIONS).to(F32)
                pi = torch.where(az_mask[:, None], res.pi, opp_pi)
                rec_valid = live & (az_mask | opp_rec)
            records.append(_record(state, pi, rec_valid))

            state = tree_select(live, nstate, state)
            carry = n_carry
            prev = mover
            decisions += (live & az_mask).sum()

    samples = SampleBatch(*(torch.stack(x) for x in zip(*records)))
    return ActorOutput(state=state, samples=samples,
                       status=rules.game_status(state, cfg), carry=carry,
                       prev_player=prev, az_decisions=decisions)


def realised_outcome(state: GameState, action: torch.Tensor,
                     dice: torch.Tensor) -> torch.Tensor:
    """[B] int32: the chance outcome of the search tree that ``action``
    with ``dice`` realises, the attacker's losses on a battle move (the
    source ``step`` picks, one ``battle`` round on the same dice), 0 on any
    other move."""
    rows = torch.arange(state.batch_size, device=state.device)
    li = action.clamp(0, NUM_LANDS - 1)
    owned_with_army = ((state.owner == state.cur_player[:, None])
                       & (state.army >= 2))
    frm = rules.best_attack_from(state, li, owned_with_army)
    a0 = state.army[rows, frm.long()]
    a1, _, _ = rules.battle(a0, state.army[rows, li.long()], dice)
    is_battle = (state.phase == PH_ATTACK) & (action != SKIP_ACTION)
    return torch.where(is_battle, a0 - a1, 0).to(I32)


def run_scripted_episodes(state0: GameState, draws, cfg: Config,
                          num_steps: int, kinds: Tuple[int, int],
                          carry_in=None, prev_in=None) -> ActorOutput:
    """Script/random-only games with every micro-decision recorded as a
    one-hot policy sample: the reference's ``train-data`` supervised
    bootstrap data generator (alphazero_trainer.cpp:227-319, where its best
    models actually came from).  ``kinds[p]`` (``OPP_SCRIPT`` or
    ``OPP_RANDOM``) plays seat p.

    Each step takes one ``(u, dice)`` from ``draws.opp()`` after
    ``draws.begin_step()``; both seats' agents see it, and the mover's
    result is kept.  Terminal games stay as they are (the agents freeze
    them).  ``carry_in``/``prev_in`` resume a chunked run.
    """
    b, dev = state0.batch_size, state0.device
    state = state0
    carry = script_agent.init_carry(b, dev) if carry_in is None else carry_in
    prev = (torch.full((b,), -1, dtype=I32, device=dev)
            if prev_in is None else prev_in)
    records = []
    for _ in range(num_steps):
        draws.begin_step()
        u, dice = draws.opp()
        reset = state.cur_player != prev
        s0, c0, (a0, r0) = _opponent_step(kinds[0], state, carry, reset, u,
                                          dice, cfg)
        if kinds[1] == kinds[0]:
            s1, c1, a1, r1 = s0, c0, a0, r0
        else:
            s1, c1, (a1, r1) = _opponent_step(kinds[1], state, carry, reset,
                                              u, dice, cfg)
        mover0 = state.cur_player == 0
        action = torch.where(mover0, a0, a1)
        pi = F.one_hot(action.long(), NUM_ACTIONS).to(F32)
        records.append(_record(state, pi, torch.where(mover0, r0, r1)))
        prev = state.cur_player
        state = tree_select(mover0, s0, s1)
        carry = tree_select(mover0, c0, c1)
    samples = SampleBatch(*(torch.stack(x) for x in zip(*records)))
    return ActorOutput(state=state, samples=samples,
                       status=rules.game_status(state, cfg), carry=carry,
                       prev_player=prev,
                       az_decisions=torch.zeros((), dtype=torch.int64,
                                                device=dev))


def backfill_values(samples: SampleBatch, status: torch.Tensor,
                    final_round: torch.Tensor | None = None,
                    round_weighted: bool = False) -> SampleBatch:
    """Game-outcome value targets: z = +-1 from each sample's player
    perspective, 0 on draw/unfinished (reference
    ``NNTrainDataStorage::updateValues``, alphazero_nn_data.cpp:51-65).
    With ``round_weighted`` (reference ROUND_WEIGHTED_VALUE), early-game
    samples are discounted by round/final_round."""
    won = status[None, :] == samples.cur_player.to(I32)
    decided = (status[None, :] == 0) | (status[None, :] == 1)
    z = torch.where(decided, torch.where(won, 1.0, -1.0), 0.0)
    if round_weighted and final_round is not None:
        w = (samples.round.to(F32)
             / final_round.clamp(min=1)[None, :]).clamp(max=1.0)
        z = z * w
    return samples._replace(value=z.to(F32))
