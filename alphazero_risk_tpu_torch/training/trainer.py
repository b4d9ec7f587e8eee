"""Evaluation driver: the part of the JAX ``Trainer`` that ``play`` needs.

Port of ``alphazero_risk_tpu/training/trainer.py`` for evaluation matches
(reference executePlay, alphazero_risk.cpp:4-47): games in mirrored pairs,
in waves of at most ``env_batch_per_device`` games, each wave driven in
chunks of ``actor_chunk_steps`` AlphaZero decisions until every game ends
(or ``max_game_steps``).  Single process, one device.  Training (learner,
replay, gating) comes with a later slice.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..agents.driver import mirrored_initial_states
from ..config import Config, STATUS_NOT_ENDED
from ..device import resolve_device
from ..env.state import new_game
from ..models.fast_infer import (default_calib_feats, fold_for_inference,
                                 make_fast_eval_fn)
from ..models.resnet import AZNet, build_network
from . import actor as A


class Trainer:
    def __init__(self, cfg: Config, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        # actor weights (the JAX trainer's gen_params/gen_batch_stats)
        self.net = build_network(cfg, self.device, seed=seed)
        # arenas and benchmarks search without root Dirichlet noise
        self._ecfg = cfg.replace(use_dirichlet_noise=False)
        self.play_stats = {"az_decisions": 0, "seconds": 0.0}

    @property
    def net(self) -> AZNet:
        return self._net

    @net.setter
    def net(self, v: AZNet):
        self._net = v.to(self.device).eval()
        self._folded = None       # re-folded lazily on first use

    def _fold(self, net: AZNet):
        calib = None
        if self.cfg.fast_infer_int8:
            g = torch.Generator(device=self.device)
            g.manual_seed(17)
            calib = default_calib_feats(self.cfg, g, device=self.device)
        return fold_for_inference(net, self.cfg,
                                  int8=self.cfg.fast_infer_int8,
                                  calib_feats=calib)

    def folded(self):
        """The BN-folded (and, with ``fast_infer_int8``, quantized and
        calibrated) inference dict of the actor weights."""
        if self._folded is None:
            self._folded = self._fold(self.net)
        return self._folded

    def _eval_fn(self):
        if self.cfg.fast_infer:
            fast = make_fast_eval_fn(self.cfg, int8=self.cfg.fast_infer_int8)
            folded = self.folded()
            return lambda s, m: fast(folded, s, m)
        return A.make_eval_fn(self.net, self.cfg)

    def _versus_call(self, opponent: int):
        """Chunk callable: (state, carry, prev) -> ActorOutput."""
        efn = self._eval_fn()
        cfg = self._ecfg

        def call(state, carry, prev):
            draws = A.GeneratorDraws(self.gen, cfg, state.batch_size,
                                     self.device)
            return A.run_episodes(efn, state, draws, cfg,
                                  cfg.actor_chunk_steps, opponent=opponent,
                                  carry_in=carry, prev_in=prev)
        return call

    def _round_games(self, games: int) -> int:
        """Games run in mirrored pairs: round up to an even count once at
        entry, so reported tallies match the games played."""
        return -(-games // 2) * 2

    def _wave_batch(self, remaining: int) -> int:
        cap = max(self.cfg.env_batch_per_device // 2, 1) * 2
        return min(cap, remaining)

    def _initial_states(self, batch: int):
        """Fresh deals, mirrored in pairs when cfg.mirror_games."""
        if self.cfg.mirror_games:
            return mirrored_initial_states(batch, generator=self.gen,
                                           device=self.device)
        state0 = new_game(batch, generator=self.gen, device=self.device)
        alt = torch.arange(batch, dtype=torch.int32, device=self.device) % 2
        return state0.replace(cur_player=alt)

    def _episode_loop(self, chunk_call, state0) -> A.ActorOutput:
        """Drive chunked episodes until every game ends (or the step
        cap), with one host check of the statuses per chunk."""
        carry, prev = None, None
        state = state0
        n_chunks = max(self.cfg.max_game_steps // self.cfg.actor_chunk_steps,
                       1)
        decisions = 0
        for _ in range(n_chunks):
            out = chunk_call(state, carry, prev)
            state, carry, prev = out.state, out.carry, out.prev_player
            decisions += int(out.az_decisions)
            status = out.status.cpu().numpy()
            if int((status == STATUS_NOT_ENDED).sum()) == 0:
                break
        self.play_stats["az_decisions"] += decisions
        return out

    def _global_tally(self, status: np.ndarray, started: np.ndarray) -> dict:
        """Win/draw tallies (single process: plain local counts)."""
        return {
            "games": int(status.shape[0]),
            "p0_wins": int((status == 0).sum()),
            "p1_wins": int((status == 1).sum()),
            "draws": int((status == -2).sum()),
            "unfinished": int((status == STATUS_NOT_ENDED).sum()),
            "p0_win_started": int(((status == 0) & (started == 0)).sum()),
            "p1_win_started": int(((status == 1) & (started == 1)).sum()),
        }

    @torch.inference_mode()
    def play(self, opponent: int, games: int):
        """Evaluation matches AZ (seat 0) vs the ScriptPlayer.  Returns a
        results summary; ``play_stats`` accumulates the AlphaZero decisions
        made and the wall time."""
        t0 = time.perf_counter()
        games = self._round_games(games)
        totals = None
        done = 0
        call = self._versus_call(opponent)
        while done < games:
            b = self._wave_batch(games - done)
            state0 = self._initial_states(b)
            out = self._episode_loop(call, state0)
            part = self._global_tally(out.status.cpu().numpy(),
                                      state0.cur_player.cpu().numpy())
            totals = part if totals is None else {
                k: totals[k] + part[k] for k in part}
            done += b
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.play_stats["seconds"] += time.perf_counter() - t0
        return totals
