"""Port: a process world plays the games of one process.

A 2-rank gloo world of CPU processes and one process, both from the same
seed, run ``generate_selfplay``, ``play`` against the ScriptPlayer (the
opponent fast-forward, whose iterations the ranks agree on) and ``gate``.
Every rank deals the global wave and draws the global random numbers and
keeps its rows (``WorldDraws``), so rank r's games are games ``[r * B / 2,
(r + 1) * B / 2)`` of each one-process wave, bit for bit: final states,
statuses, replay rows and tallies.  Without the fast-forward's agreement
the generators drift apart and the games differ (the negative case).
"""

import numpy as np
import pytest
import torch

from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.training.replay import ReplayBuffer

import torch_world as W

WORLD = 2
GAMES = 8           # two waves of four games, two a rank
CFG = Config(blocks=1, filters=16, value_hidden=8, mcts_simulations=2,
             max_depth=6, env_batch_per_device=4, max_game_steps=96,
             actor_chunk_steps=48, compare_games=GAMES)


def _cfg(tmp_path):
    return CFG.replace(checkpoint_dir=str(tmp_path / "checkpoints"),
                       data_dir=str(tmp_path / "data"),
                       log_dir=str(tmp_path / "log"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process, the world's ranks, the world without agreement)."""
    tmp = tmp_path_factory.mktemp("world")
    cfg = _cfg(tmp)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = W.trainer_runs(0, cfg, 3, GAMES)
    finally:
        torch.set_num_threads(threads)
    world = W.run_world(W.trainer_runs, WORLD, tmp, cfg, 3, GAMES,
                        timeout=300)
    drift = W.run_world(W.trainer_runs, WORLD, tmp, cfg, 3, GAMES, False,
                        ("play",), timeout=300)
    return one, world, drift


def _rows(wave, r):
    """Rank r's games of a one-process wave."""
    n = wave["status"].shape[0] // WORLD
    return slice(r * n, (r + 1) * n)


def test_selfplay_replay_equals_one_process(runs):
    """Each rank's replay is its games' rows of every one-process wave, in
    wave order: bit-equal, every field; the world's rows together are the
    one-process buffer's."""
    one, world, _ = runs
    assert W.world_equals_one(one, world, "selfplay")
    for r, rank in enumerate(world):
        want = ReplayBuffer(CFG)
        for wave in one["selfplay"]["waves"]:
            rows = _rows(wave, r)
            want.extend_from_actor(
                type(wave["samples"])(*(x[:, rows] for x in wave["samples"])),
                wave["status"][rows], final_round=wave["state"].round[rows])
        got = rank["selfplay"]["replay"]
        assert len(got["value"]) > 0
        for k, v in want.data.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{r} {k}")
        assert rank["selfplay"]["path"].endswith(
            f"training_samples.p{r}.npz")
    assert sum(len(rank["selfplay"]["replay"]["value"]) for rank in world) \
        == len(one["selfplay"]["replay"]["value"])
    assert one["selfplay"]["path"].endswith("training_samples.npz")


def test_play_against_script_equals_one_process(runs):
    """``play(OPP_SCRIPT)``: the fast-forward runs a data-dependent number
    of iterations on each rank; agreed, every game's final state and status
    equal one process's, and every rank reports the one-process tally."""
    one, world, _ = runs
    assert W.world_equals_one(one, world, "play")
    for rank in world:
        assert rank["play"]["result"] == one["play"]["result"]
    assert one["play"]["result"]["games"] == GAMES


def test_play_without_fast_forward_agreement_drifts(runs):
    """The negative case: without ``ff_agree`` a rank whose opponents stop
    early leaves its generator behind, and its later games differ."""
    one, _, drift = runs
    assert not W.world_equals_one(one, drift, "play")


def test_gate_verdict_equal_on_every_rank(runs):
    one, world, _ = runs
    assert W.world_equals_one(one, world, "gate")
    assert [rank["gate"]["result"] for rank in world] == \
        [one["gate"]["result"]] * WORLD
