"""The port's CLI against the JAX CLI: the settings file of every mode, and
the native engine's heuristic play.

Every mode but ``watch`` writes ``{log_dir}/settings.txt`` (one
``field=value`` line per ``Config`` field) before it dispatches, in both
CLIs; for the same arguments the two files are equal, line for line.  The
comparison uses the flags both CLIs accept.  Each mode's work after the
file is written is stubbed out here (the file is all that is compared);
``tests/test_torch_slice.py``, ``tests/test_torch_scripted.py`` and
``tests/test_torch_analysis.py`` run those modes for real.
"""

import dataclasses
import json
import os

import pytest

from alphazero_risk_tpu import cli as jcli
from alphazero_risk_tpu import native as jnative
from alphazero_risk_tpu.training import trainer as jtrainer

from alphazero_risk_tpu_torch import cli
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.training import analysis as tanalysis
from alphazero_risk_tpu_torch.training import trainer as ttrainer

NPZ = os.path.join(os.path.dirname(os.path.dirname(__file__)), "artifacts",
                   "params-5block-scratch-r5-iter37.npz")

MODES = {
    "play_heuristic": ["-m", "play", "--p1", "sp", "--p2", "rp", "--games",
                       "6", "--seed", "3"],
    "play_az_npz": ["-m", "play", "--p1", "az", "--p2", "sp", "--c1", NPZ,
                    "--blocks", "5", "--mcts", "4", "--fast", "--int8"],
    "train": ["-m", "train", "--ti", "2", "--tg", "8", "--e", "3", "--bs",
              "64", "--mcts", "6", "--env-batch", "8", "--max-steps", "300",
              "--ct", "0.6", "--hp", "1.5", "--dnv", "0.2", "--dne", "0.3"],
    "train_data": ["-m", "train-data", "--dtl", "2", "--dgss", "10",
                   "--dgsr", "12", "--int8", "--limit-attack", "1",
                   "--allow-yield", "0", "--mirror-games", "0"],
    "analysis": ["-m", "analysis", "--bs", "128", "--blocks", "3", "--seed",
                 "2", "--t", "20", "--limit-reinforcement", "0"],
}


class _Stop(Exception):
    pass


def _stop(*a, **kw):
    raise _Stop


@pytest.mark.parametrize("mode", sorted(MODES))
def test_settings_file_matches_jax_cli(mode, tmp_path, monkeypatch):
    """``settings.txt`` of the port's CLI equals the JAX CLI's for the
    same arguments (exact text)."""
    monkeypatch.setenv("AZR_COMPILE_CACHE", "")
    for mod in (jtrainer, ttrainer):
        monkeypatch.setattr(mod, "Trainer", _stop)
    monkeypatch.setattr(jnative, "available", _stop)
    monkeypatch.setattr(cli, "play_heuristic", _stop)
    monkeypatch.setattr(cli, "play_native", _stop)
    monkeypatch.setattr(tanalysis, "cross_validate", _stop)
    text = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        with pytest.raises(_Stop):
            main(MODES[mode] + ["--cpu"])
        with open("log/settings.txt") as f:
            text[name] = f.read()
    assert text["port"] == text["jax"]
    lines = text["port"].splitlines()
    assert [line.split("=")[0] for line in lines] == [
        f.name for f in dataclasses.fields(Config)]
    assert "log_dir=log" in lines and "checkpoint_dir=checkpoints" in lines


def test_native_play_prints_jax_json(tmp_path, monkeypatch, capsys):
    """``-m play --p1 sp --p2 rp --cpu`` on the native engine prints the
    JAX CLI's JSON, key for key and number for number."""
    monkeypatch.setenv("AZR_COMPILE_CACHE", "")
    monkeypatch.chdir(tmp_path)
    args = ["-m", "play", "--p1", "sp", "--p2", "rp", "--games", "40",
            "--seed", "9", "--cpu"]
    cli.main(args)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["engine"] == "native" and got["games"] == 40
    assert got["p0_wins"] + got["p1_wins"] + got["draws"] == 40
