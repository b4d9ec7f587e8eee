"""The port stands alone: no JAX, no module of the JAX package, and no
silent CPU fallback at its entry points."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "alphazero_risk_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "alphazero_risk_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _entry_points():
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.env.state import new_game
    from alphazero_risk_tpu_torch.models.resnet import build_network
    from alphazero_risk_tpu_torch.training.checkpoints import load_params_npz
    from alphazero_risk_tpu_torch.training.trainer import Trainer
    from alphazero_risk_tpu_torch import cli
    small = Config(blocks=1, filters=8, value_hidden=4)
    return {
        "Trainer": lambda dev: Trainer(small, device=dev),
        "new_game": lambda dev: new_game(2, device=dev),
        "build_network": lambda dev: build_network(small, device=dev),
        "load_params_npz": lambda dev: load_params_npz(
            str(ROOT / "artifacts" / "params-5block-scratch-r5-iter37.npz"),
            Config(blocks=5), device=dev),
        "cli": lambda dev: cli.main(
            ["--games", "2", "--mcts", "2", "--blocks", "1", "--max-steps",
             "1"] + (["--cpu"] if dev == "cpu" else [])),
    }


@pytest.mark.parametrize("name", ["Trainer", "new_game", "build_network",
                                  "load_params_npz", "cli"])
def test_entry_points_need_a_card_or_cpu(name, monkeypatch, capsys):
    fn = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn("cuda")
    fn("cpu")
