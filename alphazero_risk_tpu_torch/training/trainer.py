"""AlphaZero training orchestration.

Port of ``alphazero_risk_tpu/training/trainer.py`` (reference
``AlphaZeroTrainer``, alphazero_trainer.{h,cpp}): an actor-learner loop
over batched self-play, on one device or in a process world of one card
per rank.

  train:  loop { self-play -> trim -> N epochs -> gating arena ->
          accept (save best/iter, promote) / revert -> benchmark }
  train_on_data:  loop { scripted Script-vs-Script and Script-vs-Random
          games into a fresh buffer -> 3 epochs -> arena (no revert) ->
          benchmark -> temp/latest }  (the supervised bootstrap)
  train_on_script:  ``train`` with games against the ScriptPlayer in
          place of self-play
  play:   evaluation matches against the ScriptPlayer or the RandomPlayer;
          ``play_az_vs_az`` against another checkpoint

Games run in mirrored pairs, in waves of at most ``env_batch_per_device``
games, each wave driven in chunks of ``actor_chunk_steps`` micro-decisions
with one host check of the statuses per chunk, until every game ends (or
``max_game_steps``).

As in the JAX trainer, on a rejected gate ``_revert`` restores the last
*accepted* model (the reference reloads a possibly stale 'latest' file,
alphazero_trainer.cpp:170-175).

With ``cfg.device_replay`` the samples stay on the device: self-play
chunks go into a ``DeviceReplay`` ring and the epochs sample it in place
(``make_ring_epoch_fn``); ``train_epochs`` dispatches on the buffer's type.
With ``cfg.tree_reuse`` the searching paths but the arena carry each
search's subtree to the next decision (``actor.run_episodes``).

In a process world (``parallel/distributed.py``, one process per card) the
trainer keeps the JAX package's multi-host semantics: every rank deals the
same global wave and the same global draws and plays its rows of them, so
a W-rank world plays the games of one process with the same seed.  Game
counts round to multiples of lcm(2, W), ``env_batch_per_device`` caps the
global wave, the all-done check and the tallies are world sums (every
rank reaches the same gate verdict), each rank keeps its own replay
(``training_samples.p{rank}.npz``), and the learner takes ``batch_size /
W`` rows a step from each rank in one world update
(``_train_epochs_multihost``).  The device ring is single-process.
"""

from __future__ import annotations

import copy
import math
import signal
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..agents.driver import mirrored_initial_states
from ..config import Config, STATUS_NOT_ENDED
from ..device import resolve_device
from ..env import rules
from ..env.state import new_game
from ..models.fast_infer import (default_calib_feats, fold_for_inference,
                                 make_fast_eval_fn, make_fast_paired_eval_fn)
from ..models.resnet import AZNet
from ..parallel import distributed as D
from ..parallel.mesh import make_mesh, replicate, shard_batch
from ..utils import profiling
from ..utils.logging import Logs
from . import actor as A
from .checkpoints import CheckpointManager
from .device_replay import DeviceReplay
from .learner import (create_train_state, make_epoch_fn, make_ring_epoch_fn,
                      train_state_of, update)
from .replay import ReplayBuffer


def sequential_verdict(wins: int, losses: int, threshold: float,
                       z: float = 2.24, min_decided: int = 96):
    """Early verdict for a win-share gate: ``True``/``False`` once the
    accept/reject decision is statistically settled, else ``None``.

    Normal approximation to the Beta(w+1, l+1) posterior over the win
    share p, against H: p >= threshold.  Conservative: a high one-sided z
    both ways plus a decided-games floor guard against early noise and
    against the mild length-vs-outcome correlation inherent in stopping a
    lockstep arena mid-flight (fast winners are tallied before slow ones).
    """
    n = wins + losses
    if n < min_decided:
        return None
    mean = (wins + 1) / (n + 2)
    sd = math.sqrt(mean * (1.0 - mean) / (n + 3))
    stat = (mean - threshold) / max(sd, 1e-9)
    if stat > z:
        return True
    if stat < -z:
        return False
    return None


class Trainer:
    def __init__(self, cfg: Config, seed: int = 0, device="cuda",
                 log_dir: Optional[str] = None):
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        # the process world (parallel/distributed.py): replay stays
        # rank-local, games and minibatches are split over the ranks
        self.world, self.rank = D.world(), D.rank()
        if cfg.device_replay and self.world > 1:
            raise ValueError(
                "device_replay is single-process only: the multi-process "
                "path splits episode batches and keeps replay rank-local")
        self.mesh = make_mesh(axis=cfg.dp_axis, device=self.device) \
            if self.world > 1 else None
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.train_state = create_train_state(cfg, seed, self.device)
        if self.mesh is not None:
            replicate(self.mesh, self.train_state.net)
        # generate/actor model = last accepted weights
        # (reference "az_generate" group, alphazero_risk.cpp:49-62)
        self.net = copy.deepcopy(self.train_state.net)
        self.replay = self._new_buffer()
        self.logs = Logs(log_dir or cfg.log_dir)
        self.ckpt = CheckpointManager(cfg)
        self.iteration = 0
        # Exploration noise belongs to self-play generation only; arenas
        # and benchmarks search without root Dirichlet noise.
        self._ecfg = cfg.replace(use_dirichlet_noise=False)
        self._epoch = make_epoch_fn(cfg, prepare_batch=self._prepare_batch)
        self._ring_epoch = make_ring_epoch_fn(
            cfg, prepare_batch=self._prepare_batch)
        self.epoch_log = []       # one dict of losses per epoch trained
        # az_decisions: searches made for live AlphaZero movers; steps:
        # lockstep micro-steps driven (one search of the batch each but in
        # scripted games), of
        # which paired_steps ran the two-net arena eval; folds: inference
        # dicts folded; seconds: wall time inside play()
        self.play_stats = {"az_decisions": 0, "steps": 0, "paired_steps": 0,
                           "folds": 0, "seconds": 0.0}

    # ------------------------------------------------------------------
    # Actor weights: the last accepted network.  Assigning it drops the
    # cached BN-folded inference dict (re-folded lazily on first use).
    @property
    def net(self) -> AZNet:
        return self._net

    @net.setter
    def net(self, v: AZNet):
        self._net = v.to(self.device).eval()
        self._folded = None

    def load_weights(self, net: AZNet) -> None:
        """Start both the learner and the actor from ``net``'s weights."""
        self.net = net
        self.train_state = train_state_of(copy.deepcopy(self.net), self.cfg)

    def _fold(self, net: AZNet):
        calib = None
        if self.cfg.fast_infer_int8:
            g = torch.Generator(device=self.device)
            g.manual_seed(17)
            calib = default_calib_feats(self.cfg, g, device=self.device)
        self.play_stats["folds"] += 1
        return fold_for_inference(net, self.cfg,
                                  int8=self.cfg.fast_infer_int8,
                                  calib_feats=calib)

    def folded(self):
        """The BN-folded (and, with ``fast_infer_int8``, quantized and
        calibrated) inference dict of the actor weights."""
        if self._folded is None:
            self._folded = self._fold(self.net)
        return self._folded

    def _folded_of(self, net: AZNet):
        """Folded dict for any network, reusing the actor cache when the
        network IS the actor network."""
        return self.folded() if net is self._net else self._fold(net)

    def _eval_fn(self, net: Optional[AZNet] = None):
        net = self.net if net is None else net
        if self.cfg.fast_infer:
            fast = make_fast_eval_fn(self.cfg, int8=self.cfg.fast_infer_int8)
            folded = self._folded_of(net)
            return lambda s, m: fast(folded, s, m)
        return A.make_eval_fn(net, self.cfg)

    # ---- chunk-callable builders: (state, carry, prev) -> ActorOutput ----
    # The searching ones refuse full cards before folding a network (the
    # search has no card uniform, as in the JAX package).
    def _draws(self, cfg: Config, batch: int):
        """The draws of a chunk of ``batch`` games (this rank's rows of the
        world's draws in a process world)."""
        kind = A.WorldDraws if self.world > 1 else A.GeneratorDraws
        return kind(self.gen, cfg, batch, self.device)

    def _chunk_call(self, efn, cfg, **kw):
        def call(state, carry, prev):
            draws = self._draws(cfg, state.batch_size)
            return A.run_episodes(efn, state, draws, cfg,
                                  cfg.actor_chunk_steps, carry_in=carry,
                                  prev_in=prev, **kw)
        return call

    def _selfplay_call(self):
        rules.require_uniform(self.cfg, None)
        return self._chunk_call(self._eval_fn(), self.cfg,
                                sample_moves=True)

    def _arena_call(self, net_a: AZNet, net_b: AZNet):
        rules.require_uniform(self.cfg, None)
        if self.cfg.fast_infer:
            fastp = make_fast_paired_eval_fn(
                self.cfg, int8=self.cfg.fast_infer_int8)
            fa, fb = self._folded_of(net_a), self._folded_of(net_b)
            efn = lambda s, m, use_a: fastp(fa, fb, use_a, s, m)  # noqa: E731
        else:
            efn = A.make_paired_eval_fn(net_a, net_b, self.cfg)
        return self._chunk_call(efn, self._ecfg, sample_moves=False,
                                paired_eval=True)

    def _versus_call(self, net: AZNet, opponent: int, record: bool):
        rules.require_uniform(self.cfg, None)
        return self._chunk_call(self._eval_fn(net), self._ecfg,
                                opponent=opponent, az_seats=(True, False),
                                sample_moves=False, record_all=record)

    def _scripted_call(self, kinds: Tuple[int, int]):
        def call(state, carry, prev):
            draws = self._draws(self.cfg, state.batch_size)
            return A.run_scripted_episodes(
                state, draws, self.cfg, self.cfg.actor_chunk_steps, kinds,
                carry_in=carry, prev_in=prev)
        return call

    def _new_buffer(self):
        """An empty replay buffer: the device ring under
        ``cfg.device_replay``, else the host buffer."""
        if self.cfg.device_replay:
            return DeviceReplay(self.cfg, self.device)
        return ReplayBuffer(self.cfg)

    # ------------------------------------------------------------------
    def _game_unit(self) -> int:
        """Games run in mirrored pairs and split over the world's ranks, so
        counts are multiples of lcm(2, world)."""
        return math.lcm(2, self.world)

    def _round_games(self, games: int) -> int:
        """Round a requested game count up to the unit once at entry, so
        reported tallies match the games played."""
        unit = self._game_unit()
        return -(-games // unit) * unit

    def _wave_batch(self, remaining: int) -> int:
        """The next wave's global batch: ``env_batch_per_device`` caps it,
        as in JAX."""
        unit = self._game_unit()
        cap = max(self.cfg.env_batch_per_device // unit, 1) * unit
        return min(cap, remaining)

    def _replay_path(self) -> str:
        """The replay file; a rank of a world keeps its own games in its
        own file."""
        base = f"{self.cfg.data_dir}/training_samples"
        if self.world > 1:
            return f"{base}.p{self.rank}.npz"
        return f"{base}.npz"

    def _install_sigint_flush(self):
        """Flush the replay buffer to disk on Ctrl-C (reference SIGINT
        handler, alphazero_nn_data.cpp:140-152)."""
        def handler(signum, frame):
            print("\n=> SIGINT: saving training samples.")
            self.replay.save(self._replay_path())
            raise KeyboardInterrupt

        signal.signal(signal.SIGINT, handler)

    def _initial_states(self, batch: int):
        """Fresh deals of a global wave of ``batch`` games, mirrored in
        pairs when cfg.mirror_games; in a process world, this rank's rows
        of them."""
        if self.cfg.mirror_games:
            state0 = mirrored_initial_states(batch, generator=self.gen,
                                             device=self.device)
        else:
            state0 = new_game(batch, generator=self.gen, device=self.device)
            alt = torch.arange(batch, dtype=torch.int32,
                               device=self.device) % 2
            state0 = state0.replace(cur_player=alt)
        if self.mesh is not None:
            state0 = shard_batch(self.mesh, state0)
        return state0

    def _prepare_batch(self, data, idx):
        return A.prepare_samples(data, idx, self.cfg)

    @torch.inference_mode()
    def _episode_loop(self, chunk_call, state0, early_stop=None,
                      paired: bool = False) -> A.ActorOutput:
        """Drive chunked episodes until every game ends (or the step cap),
        with one host check of the statuses per chunk.

        ``early_stop(status)``, when given, is called with the numpy status
        row after every chunk; returning True abandons the still-running
        games (they stay STATUS_NOT_ENDED and are excluded from tallies).
        The returned samples are all chunks' records, [T, B, ...].

        In a process world the state, samples and status are this rank's
        games; the all-done check is a world sum, so the ranks run the
        same chunks, and ``early_stop`` must answer the same on every rank
        (``_global_tally`` does).  Under the profiler the blocking reads of
        a chunk's results are one ``host.sync`` span.
        """
        carry, prev = None, None
        state = state0
        n_chunks = max(self.cfg.max_game_steps // self.cfg.actor_chunk_steps,
                       1)
        chunks = []
        decisions = 0
        for _ in range(n_chunks):
            out = chunk_call(state, carry, prev)
            chunks.append(out.samples)
            state, carry, prev = out.state, out.carry, out.prev_player
            with profiling.span("host.sync"):
                decisions += int(out.az_decisions)
                status = out.status.cpu().numpy()
            live = int((status == STATUS_NOT_ENDED).sum())
            if self.world > 1:
                live = int(D.allgather_metrics({"live": live})["live"])
            if live == 0:
                break
            if early_stop is not None and early_stop(status):
                break
        self.play_stats["az_decisions"] += decisions
        steps = len(chunks) * self.cfg.actor_chunk_steps
        self.play_stats["steps"] += steps
        self.play_stats["paired_steps"] += steps if paired else 0
        samples = A.SampleBatch(*(torch.cat(x) for x in zip(*chunks)))
        return out._replace(samples=samples)

    # ------------------------------------------------------------------
    def generate_selfplay(self, games: Optional[int] = None) -> int:
        """One generation phase (reference generateTrainData,
        alphazero_trainer.cpp:36-78)."""
        games = self._round_games(games or self.cfg.train_iteration_games)
        added = 0
        done_games = 0
        finished = 0
        while done_games < games:
            b = self._wave_batch(games - done_games)
            state0 = self._initial_states(b)
            out = self._episode_loop(self._selfplay_call(), state0)
            added += self.replay.extend_from_actor(
                out.samples, out.status, final_round=out.state.round)
            finished += int((out.status != STATUS_NOT_ENDED).sum())
            done_games += b
        self.logs.event("selfplay", games=done_games, finished=finished,
                        samples=added, buffer=len(self.replay))
        return added

    def train_epochs(self, epochs: Optional[int] = None
                     ) -> Tuple[float, float]:
        """N shuffled epochs over the buffer (reference train,
        alphazero_nn.cpp:351-410)."""
        epochs = epochs or self.cfg.epochs
        if self.world > 1:
            return self._train_epochs_multihost(epochs)
        # the buffer's type, not the flag: a caller may swap in either
        if isinstance(self.replay, DeviceReplay):
            return self._train_epochs_ring(epochs)
        arrays = self.replay.sample_arrays()
        n = next(iter(arrays.values())).shape[0]
        cap = self.cfg.train_upload_max_samples
        if cap and n > cap:
            return self._train_epochs_chunked(arrays, n, cap, epochs)
        data = self._upload(arrays)
        pi_loss = v_loss = float("nan")
        for e in range(epochs):
            self.train_state, metrics = self._epoch(
                self.train_state, data, generator=self.gen)
            pi_loss, v_loss = self._log_epoch(
                e, float(metrics["pi_loss"]), float(metrics["v_loss"]),
                float(metrics["first_pi_loss"]))
        return pi_loss, v_loss

    def _train_epochs_ring(self, epochs: int) -> Tuple[float, float]:
        """Epochs over the device-resident ring: no upload, the samples
        were ingested on the device."""
        data, start, size = self.replay.epoch_view()
        pi_loss = v_loss = float("nan")
        for e in range(epochs):
            self.train_state, metrics = self._ring_epoch(
                self.train_state, data, start, size, generator=self.gen)
            pi_loss, v_loss = self._log_epoch(
                e, float(metrics["pi_loss"]), float(metrics["v_loss"]),
                float(metrics["first_pi_loss"]))
        return pi_loss, v_loss

    def _upload(self, arrays, idx=None):
        return {k: torch.from_numpy(v if idx is None else v[idx])
                .to(self.device) for k, v in arrays.items()}

    def _log_epoch(self, e: int, pi_loss: float, v_loss: float,
                   first_pi_loss: float):
        self.epoch_log.append({"iteration": self.iteration, "epoch": e,
                               "pi_loss": pi_loss, "v_loss": v_loss,
                               "first_pi_loss": first_pi_loss})
        self.logs.log_nn_epoch(self.iteration, e, pi_loss, v_loss)
        return pi_loss, v_loss

    def _train_epochs_chunked(self, arrays, n: int, cap: int, epochs: int
                              ) -> Tuple[float, float]:
        """Epochs over a buffer too large for one device-resident slice:
        fixed-size chunks, each shuffled and trained by the same epoch
        function; the tail chunk wraps around.  Block-shuffled SGD:
        within-chunk order is fully random, chunk order is buffer order."""
        k = math.ceil(n / cap)
        chunk = min(cap, n)
        pi_loss = v_loss = float("nan")
        for e in range(epochs):
            pi_sum = v_sum = 0.0
            first = float("nan")
            for c in range(k):
                lo = c * chunk
                idx = np.arange(lo, lo + chunk) % n    # tail wraps
                data = self._upload(arrays, idx)
                self.train_state, metrics = self._epoch(
                    self.train_state, data, generator=self.gen)
                pi_sum += float(metrics["pi_loss"])
                v_sum += float(metrics["v_loss"])
                if c == 0:
                    first = float(metrics["first_pi_loss"])
                del data
            pi_loss, v_loss = self._log_epoch(e, pi_sum / k, v_sum / k,
                                              first)
        return pi_loss, v_loss

    def _train_epochs_multihost(self, epochs: int) -> Tuple[float, float]:
        """Epochs of a process world (JAX ``_train_epochs_multihost``):
        each rank shuffles its own replay and gives ``batch_size / world``
        rows a step to one world update (``learner.update``: the update of
        the concatenated global minibatch).  The steps come from the
        world's shortest buffer, so the ranks update in lockstep; each rank
        shuffles its full buffer and truncates, so a longer buffer does not
        train only its oldest rows.  No upload cap, as in JAX."""
        cfg = self.cfg
        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} does not split "
                             f"over {self.world} processes")
        bs_local = cfg.batch_size // self.world
        steps = D.allgather_min(len(self.replay)) // bs_local
        if steps == 0:
            return float("nan"), float("nan")
        data = self._upload(self.replay.sample_arrays())
        seed = int(torch.randint(0, np.iinfo(np.int32).max, (),
                                 generator=self.gen,
                                 device=self.gen.device))
        rng = np.random.default_rng(seed + self.rank)
        pi_loss = v_loss = float("nan")
        for e in range(epochs):
            perm = rng.permutation(len(self.replay))[:steps * bs_local]
            perm = torch.from_numpy(perm).to(self.device).reshape(
                steps, bs_local)
            sums = torch.zeros(2, dtype=torch.float32, device=self.device)
            first = None
            for idx in perm:
                self.train_state, m = update(
                    self.train_state, cfg, self._prepare_batch(data, idx))
                if first is None:
                    first = m["pi_loss"]
                sums += torch.stack([m["pi_loss"], m["v_loss"]])
            pi_loss, v_loss = (sums / steps).tolist()
            self._log_epoch(e, pi_loss, v_loss, float(first))
        return pi_loss, v_loss

    def gate(self, revert_on_fail: Optional[bool] = None) -> bool:
        """Arena new-vs-old; accept at >= compare_threshold win share
        (reference updateIfImprovement, alphazero_trainer.cpp:134-198)."""
        cfg = self.cfg
        if revert_on_fail is None:
            revert_on_fail = cfg.training_revert_model
        if cfg.compare_games <= 0:
            self._accept()
            return True
        games = self._round_games(cfg.compare_games)
        arena = self._arena_call(self.train_state.net, self.net)

        def _merge(base, part):
            return part if base is None else {
                k: base[k] + part[k] for k in part}

        def _verdict(t):
            return sequential_verdict(
                t["p0_wins"], t["p1_wins"], cfg.compare_threshold,
                z=cfg.arena_early_stop_z,
                min_decided=cfg.arena_early_stop_min_games)

        tally = None
        done = 0
        decided = None
        while done < games and decided is None:
            b = self._wave_batch(games - done)
            state0 = self._initial_states(b)
            started = state0.cur_player.cpu().numpy()
            check = None
            if cfg.arena_early_stop:
                # per-chunk sequential test on the finished games
                def check(status, _started=started):
                    t = _merge(tally, self._global_tally(status, _started))
                    return _verdict(t) is not None
            out = self._episode_loop(arena, state0, early_stop=check,
                                     paired=True)
            if cfg.include_compare_games_train_samples:
                self.replay.extend_from_actor(
                    out.samples, out.status, final_round=out.state.round)
            tally = _merge(tally, self._global_tally(
                out.status.cpu().numpy(), started))
            done += b
            if cfg.arena_early_stop:
                decided = _verdict(tally)
        new_wins = tally["p0_wins"]
        old_wins = tally["p1_wins"]
        self.logs.log_improvement(
            self.iteration, tally["draws"], new_wins,
            tally["p0_win_started"], old_wins, tally["p1_win_started"])
        improved = (decided if decided is not None else
                    new_wins >= (new_wins + old_wins)
                    * cfg.compare_threshold)
        if cfg.arena_early_stop:
            # 'unfinished' = games abandoned mid-wave by the early stop
            self.logs.event("gate_early_stop", decided=decided,
                            new_wins=new_wins, old_wins=old_wins,
                            scheduled=games,
                            unfinished=tally["unfinished"])
        if improved:
            self._accept()
        elif revert_on_fail:
            self._revert()
        return bool(improved)

    def _global_tally(self, status: np.ndarray, started: np.ndarray) -> dict:
        """Win/draw tallies of this rank's status rows, summed over the
        world (single process: plain local counts)."""
        t = {
            "games": int(status.shape[0]),
            "p0_wins": int((status == 0).sum()),
            "p1_wins": int((status == 1).sum()),
            "draws": int((status == -2).sum()),
            "unfinished": int((status == STATUS_NOT_ENDED).sum()),
            "p0_win_started": int(((status == 0) & (started == 0)).sum()),
            "p1_win_started": int(((status == 1) & (started == 1)).sum()),
        }
        if self.world > 1:
            t = {k: int(v) for k, v in D.allgather_metrics(t).items()}
        return t

    def _accept(self):
        self.net = copy.deepcopy(self.train_state.net)
        self.ckpt.save("best", self.train_state)
        # NOT 'latest': train() writes latest + meta back to back at its
        # loop end, and that pair is the resume anchor.  A mid-loop
        # 'latest' here could be cut off from its meta and resume the
        # iteration with post-accept weights under the old meta.
        self.ckpt.save(f"iter-{self.iteration}", self.train_state)

    def _revert(self):
        """Back to the last accepted weights; the Adam state stays, as the
        JAX trainer keeps ``opt_state``."""
        self.train_state.net.load_state_dict(self.net.state_dict())

    def benchmark(self):
        """vs Random and vs Script (reference benchmark,
        alphazero_trainer.cpp:121-132)."""
        cfg = self.cfg
        results = []
        for opp, games in ((A.OPP_RANDOM, cfg.benchmark_games_random),
                           (A.OPP_SCRIPT, cfg.benchmark_games_script)):
            results.append(self.play(opp, games))
        self.logs.log_benchmark(self.iteration, results[0], results[1])
        return results

    # ------------------------------------------------------------------
    def _save_meta(self):
        self.ckpt.save_meta({
            "iteration": self.iteration + 1,
            "generator_device": self.device.type,
            "generator_state": self.gen.get_state().tolist(),
        })

    def _restore_meta(self) -> int:
        """Restore {iteration, generator state}; returns the start
        iteration.  Without this a restart would overwrite iter-N
        checkpoints from 0 and reseed identically, replaying the same game
        deals.  A state saved by another device type's generator does not
        fit this one: the generator is then reseeded from the seed and the
        iteration."""
        meta = self.ckpt.load_meta()
        if not meta:
            return 0
        start = int(meta["iteration"])
        if meta.get("generator_device") == self.device.type:
            self.gen.set_state(torch.tensor(meta["generator_state"],
                                            dtype=torch.uint8))
        else:
            self.gen.manual_seed(self.seed + 1_000_003 * start)
        return start

    def train(self, iterations: Optional[int] = None, resume: bool = True,
              do_benchmark: bool = True):
        """Full AlphaZero loop (reference train, alphazero_trainer.cpp:12-34).
        ``iterations`` = number of iterations to run THIS call; on resume
        the iteration counter continues from the persisted value."""
        cfg = self.cfg
        start = 0
        if resume:
            self.train_state = self.ckpt.restore("latest", self.train_state)
            # actor weights = last *accepted* model
            src = (self.ckpt.restore("best", self.train_state)
                   if self.ckpt.exists("best") else self.train_state)
            self.net = copy.deepcopy(src.net)
            self.replay.load(self._replay_path())
            start = self._restore_meta()
        self._install_sigint_flush()
        n = iterations or cfg.train_iterations
        for self.iteration in range(start, start + n):
            t0 = time.time()
            self.generate_selfplay()
            self.replay.trim()
            self.train_epochs()
            if self.gate():
                self.replay.mark_old_games()
                if do_benchmark:
                    self.benchmark()
            self.logs.event("iteration", n=self.iteration,
                            seconds=time.time() - t0)
            self.ckpt.save("latest", self.train_state)
            self._save_meta()
        self.replay.save(self._replay_path())

    def train_on_script(self, iterations: Optional[int] = None):
        """Generate data by playing AZ (the learner's weights) vs the
        ScriptPlayer instead of self-play, every decision recorded
        (reference trainOnScript, alphazero_trainer.cpp:200-225)."""
        cfg = self.cfg
        for self.iteration in range(iterations or cfg.train_iterations):
            games = self._round_games(cfg.train_iteration_games * 2)
            done = 0
            while done < games:
                b = self._wave_batch(games - done)
                state0 = self._initial_states(b)
                out = self._episode_loop(
                    self._versus_call(self.train_state.net, A.OPP_SCRIPT,
                                      record=True), state0)
                self.replay.extend_from_actor(
                    out.samples, out.status, final_round=out.state.round)
                done += b
            self.replay.trim()
            self.train_epochs()
            if self.gate():
                self.replay.mark_old_games()
            # loop-end resume anchor (latest + meta written together)
            self.ckpt.save("latest", self.train_state)
            self._save_meta()
        self.replay.save(self._replay_path())

    def train_on_data(self, loops: Optional[int] = None,
                      do_benchmark: bool = True):
        """Supervised bootstrap from heuristic games (reference
        trainOnGeneratedData, alphazero_trainer.cpp:227-319): each loop
        plays ``data_games_ss`` Script-vs-Script and ``data_games_sr``
        Script-vs-Random games into a fresh buffer, trains 3 epochs on it,
        runs the arena without reverting, benchmarks an accepted model, and
        saves ``temp``, ``latest`` and the meta."""
        cfg = self.cfg
        for self.iteration in range(loops or cfg.data_train_loops):
            fresh = self._new_buffer()
            for kinds, games in (((A.OPP_SCRIPT, A.OPP_SCRIPT),
                                  cfg.data_games_ss),
                                 ((A.OPP_SCRIPT, A.OPP_RANDOM),
                                  cfg.data_games_sr)):
                games = self._round_games(games)
                done = 0
                while done < games:
                    b = self._wave_batch(games - done)
                    state0 = self._initial_states(b)
                    out = self._episode_loop(self._scripted_call(kinds),
                                             state0)
                    fresh.extend_from_actor(out.samples, out.status,
                                            final_round=out.state.round)
                    done += b
            self.replay = fresh
            self.train_epochs(epochs=3)
            if self.gate(revert_on_fail=False) and do_benchmark:
                self.benchmark()
            self.ckpt.save("temp", self.train_state)
            # loop-end resume anchor (see train()/_accept)
            self.ckpt.save("latest", self.train_state)
            self._save_meta()

    def play_az_vs_az(self, other_role: str, games: int):
        """AZ-vs-AZ matches between the loaded model (seat 0, the learner's
        weights) and another checkpoint role (seat 1), argmax moves,
        mirrored pairs (reference executePlay with -p1 az -p2 az,
        alphazero_risk.cpp:4-47)."""
        other = self.ckpt.restore(other_role, self.train_state)
        games = self._round_games(games)
        call = self._arena_call(self.train_state.net, other.net)
        totals = None
        done = 0
        while done < games:
            b = self._wave_batch(games - done)
            state0 = self._initial_states(b)
            out = self._episode_loop(call, state0, paired=True)
            part = self._global_tally(out.status.cpu().numpy(),
                                      state0.cur_player.cpu().numpy())
            totals = part if totals is None else {
                k: totals[k] + part[k] for k in part}
            done += b
        return totals

    def play(self, opponent: int, games: int):
        """Evaluation matches AZ (seat 0, the actor weights) vs the
        ScriptPlayer or the RandomPlayer (reference executePlay,
        alphazero_risk.cpp:4-47).  Returns a results summary;
        ``play_stats`` accumulates the AlphaZero decisions made and the
        wall time."""
        t0 = time.perf_counter()
        games = self._round_games(games)
        totals = None
        done = 0
        call = self._versus_call(self.net, opponent, record=False)
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
