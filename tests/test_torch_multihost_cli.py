"""Port: what a process world refuses, who writes its checkpoints, the
CLI's multi-host flags and ``parallel/smoke.py``.

Each world is a few gloo processes on 127.0.0.1 at a free port, on the CPU,
each with its own timeout (``torch_world.run_world``, or the CLI and the
smoke as subprocesses).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from alphazero_risk_tpu import cli as jcli
from alphazero_risk_tpu.parallel import distributed as JD
from alphazero_risk_tpu.training import trainer as jtrainer

from alphazero_risk_tpu_torch import cli
from alphazero_risk_tpu_torch.parallel import distributed as D

import torch_world as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ guards

@pytest.fixture(scope="module")
def guards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("guards")
    return W.run_world(W.guards, 2, tmp, str(tmp))


def test_exists_on_some_ranks_only_raises_on_every_rank(guards):
    for out in guards:
        assert "must be a shared filesystem" in out["exists"]


def test_device_replay_in_a_world_raises(guards):
    for out in guards:
        assert "single-process only" in out["device_replay"]


def test_batch_size_must_split_over_the_world(guards):
    for out in guards:
        assert "does not split over 2 processes" in out["batch_size"]


def test_only_rank_0_writes_checkpoints(guards):
    rank0, rank1 = guards
    assert [os.path.basename(p) for p in rank0["writes"]] == ["latest.pt.tmp"]
    assert rank1["writes"] == []
    for out in guards:
        # each rank read the files after the barrier
        assert out["shared"] == ["latest.pt", "meta.json"]
        assert out["exists_shared"] is True


def test_nccl_with_two_ranks_on_one_card_raises():
    """The check ``initialize`` runs on the world's placements under NCCL
    (the placements are gathered over a gloo side group)."""
    with pytest.raises(ValueError, match="--cpu-collectives gloo"):
        D.check_placement("nccl", [("h", 0), ("h", 1), ("h", 0)])
    D.check_placement("gloo", [("h", 0), ("h", 0)])
    D.check_placement("nccl", [("a", 0), ("b", 0), ("a", 1)])


def test_cpu_world_needs_cpu_collectives(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="--cpu-collectives gloo"):
        D.initialize("127.0.0.1:1", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="--cpu-collectives gloo"):
        cli.main(["-m", "train", "--cpu", "--coordinator", "127.0.0.1:1",
                  "--nprocs", "2", "--procid", "0"])
    with pytest.raises(ValueError, match="--coordinator, --nprocs"):
        D.initialize(None, 2, 0, "gloo", device="cpu")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- the CLI

# the size of the README's tiny training run on the CPU:
# the flags both CLIs take, and those of four fields the JAX CLI has none for
COMMON = ["-m", "train", "--cpu", "--blocks", "1", "--mcts", "2", "--ti",
          "1", "--tg", "4", "--games", "4", "--e", "1", "--bs", "32",
          "--env-batch", "4", "--max-steps", "96", "--fast", "--int8"]
TINY = COMMON + ["--filters", "16", "--value-hidden", "8",
                 "--bench-random", "2", "--bench-script", "2"]
PORT_ONLY = {"filters": "16", "value_hidden": "8",
             "benchmark_games_random": "2", "benchmark_games_script": "2"}


class _Stop(Exception):
    pass


def _stop(*a, **kw):
    raise _Stop


def test_cli_trains_in_a_2_process_world(tmp_path, monkeypatch):
    """Two ``-m train`` processes of one gloo world on the CPU: both end
    with rc 0, each writes its replay file, one ``latest`` is left in the
    shared directory, and ``settings.txt`` is the JAX CLI's for the same
    arguments."""
    port = W.free_port()
    world = ["--cpu-collectives", "gloo", "--coordinator",
             f"127.0.0.1:{port}", "--nprocs", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "alphazero_risk_tpu_torch.cli", *TINY,
         *world, "--procid", str(r)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    last = [out.strip().splitlines()[-1] for out in outs]
    assert last[0] == last[1]               # the same losses on both ranks
    data = sorted(os.listdir(tmp_path / "data"))
    assert data == ["training_samples.p0.npz", "training_samples.p1.npz"]
    ck = sorted(os.listdir(tmp_path / "checkpoints"))
    assert "latest.pt" in ck and "meta.json" in ck
    assert not [f for f in ck if f.endswith(".tmp")]
    port_text = (tmp_path / "log" / "settings.txt").read_text()
    # the JAX CLI's file for the same arguments but the port-only flags (its
    # world and trainer stubbed: only the file is compared); those four
    # lines hold the port's values
    monkeypatch.setenv("AZR_COMPILE_CACHE", "")
    monkeypatch.setattr(JD, "initialize", lambda *a, **kw: None)
    monkeypatch.setattr(jtrainer, "Trainer", _stop)
    os.makedirs(tmp_path / "jax")
    monkeypatch.chdir(tmp_path / "jax")
    with pytest.raises(_Stop):
        jcli.main(COMMON + world + ["--procid", "0"])
    jax_lines = (tmp_path / "jax" / "log" / "settings.txt").read_text() \
        .splitlines()
    want = [f"{line.split('=')[0]}={PORT_ONLY[line.split('=')[0]]}"
            if line.split("=")[0] in PORT_ONLY else line
            for line in jax_lines]
    assert port_text.splitlines() == want


def test_parallel_smoke_trim_in_4_cpu_processes():
    out = subprocess.run(
        [sys.executable, "-m", "alphazero_risk_tpu_torch.parallel.smoke",
         "--nprocs", "4", "--trim", "--cpu", "--timeout", "200"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"] and summary["nprocs"] == 4
    assert summary["backend"] == "gloo"
    assert summary["devices"] == ["cpu"] * 4
