"""The port stands alone: no JAX, no module of the JAX package, and no
silent CPU fallback at its entry points."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "alphazero_risk_tpu_torch").rglob("*.py")) + [
    ROOT / "tests" / "torch_cases.py", ROOT / "tools" / "time_kernels.py"]
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
    from alphazero_risk_tpu_torch.training.analysis import cross_validate
    from alphazero_risk_tpu_torch.training.checkpoints import load_params_npz
    from alphazero_risk_tpu_torch.training.device_replay import DeviceReplay
    from alphazero_risk_tpu_torch.training.trainer import Trainer
    from alphazero_risk_tpu_torch.utils.watch import watch_game_az
    from alphazero_risk_tpu_torch import cli
    small = Config(blocks=1, filters=8, value_hidden=4)
    return {
        "watch_game_az": lambda dev: watch_game_az(
            "az", "sp", cfg=small.replace(mcts_simulations=2), pause=False,
            max_steps=2, device=dev),
        # the native engine plays heuristic matches only under --cpu;
        # without it the CLI plays them on the card
        "NativeEngine": lambda dev: cli.main(
            ["-m", "play", "--p1", "sp", "--p2", "rp", "--games", "2"]
            + (["--cpu"] if dev == "cpu" else [])),
        "Trainer": lambda dev: Trainer(small, device=dev),
        "Trainer_ring": lambda dev: Trainer(
            small.replace(device_replay=True,
                          samples_storage_max_batches=1), device=dev),
        "DeviceReplay": lambda dev: DeviceReplay(
            small.replace(samples_storage_max_batches=1), device=dev),
        "cross_validate": lambda dev: cross_validate(
            small, str(ROOT / "missing.npz"), device=dev),
        "new_game": lambda dev: new_game(2, device=dev),
        "build_network": lambda dev: build_network(small, device=dev),
        "load_params_npz": lambda dev: load_params_npz(
            str(ROOT / "artifacts" / "params-5block-scratch-r5-iter37.npz"),
            Config(blocks=5), device=dev),
        "cli": lambda dev: cli.main(
            ["--games", "2", "--mcts", "2", "--blocks", "1", "--max-steps",
             "1"] + (["--cpu"] if dev == "cpu" else [])),
    }


@pytest.mark.parametrize("name", ["Trainer", "Trainer_ring", "DeviceReplay",
                                  "cross_validate", "new_game",
                                  "build_network", "load_params_npz", "cli",
                                  "watch_game_az", "NativeEngine"])
def test_entry_points_need_a_card_or_cpu(name, monkeypatch, capsys,
                                         tmp_path):
    # the CLI and the viewer write settings and checkpoints where they run
    monkeypatch.chdir(tmp_path)
    fn = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn("cuda")
    fn("cpu")


def test_import_builds_and_loads_nothing():
    """Importing every module of the port compiles no kernel, loads no
    library and imports no ``triton``; each kernel's source is in the tree
    and defines its entry point."""
    import importlib
    import pkgutil
    import sys

    import alphazero_risk_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for mod in ("training.learner", "training.replay", "training.trainer",
                "training.device_replay", "training.analysis", "env.checks",
                "agents.random_agent", "utils.logging", "cli", "env.oracle",
                "agents.oracle_agents", "utils.board", "utils.watch",
                "utils.profiling", "native", "parallel.distributed",
                "parallel.mesh", "parallel.smoke"):
        assert f"{pkg.__name__}.{mod}" in names
    assert "triton" not in sys.modules
    from alphazero_risk_tpu_torch import kernels
    assert [k.name for k in kernels.ALL] == [
        "conv3x3_i8", "mcts_descend", "mcts_backup", "conv3x3_bf16",
        "heads_eval", "write_nodes", "rules_step", "state_views",
        "script_step", "random_step", "agent_steps", "stem_bf16"]
    for k in kernels.ALL:
        assert k._fn is None and k.build_log == ""
        assert f'extern "C" int {k.symbol}(' in k.source.read_text()
        for h in k.headers:
            assert f'#include "{h.name}"' in k.source.read_text()


def test_kernel_flags_are_per_source():
    """The kernels held bit for bit against their plain versions keep the
    common flags (``--fmad=false``), and so their library names; the bf16
    conv and the heads are built with the compiler's default contraction."""
    from alphazero_risk_tpu_torch import kernels
    exact = {"conv3x3_i8", "mcts_descend", "mcts_backup", "write_nodes",
             "rules_step", "state_views", "script_step", "random_step",
             "agent_steps"}
    for k in kernels.ALL:
        if k.name in exact:
            assert k.flags == kernels.NVCC_FLAGS
        else:
            assert "--fmad=false" not in k.flags
            assert [f for f in kernels.NVCC_FLAGS
                    if f != "--fmad=false"] == k.flags
    # one library per source, one source per kernel
    assert len({k.library for k in kernels.ALL}) == len(
        {k.source for k in kernels.ALL}) == len(kernels.ALL)


def test_kernel_library_names_follow_their_headers(tmp_path, monkeypatch):
    """A rules kernel's library name hashes the shared headers too, so an
    edit of ``rules_dev.cuh`` or ``rules_warp.cuh`` rebuilds the five warp
    kernels (K7, K8, K9, K10 and their multi-step entry); the two convs
    (K4 in both its designs) share ``conv_tc.cuh`` the same way, and K1
    also hashes its wide design's ``conv_i8_wide.cuh``."""
    from alphazero_risk_tpu_torch import kernels
    warp = ["rules_dev.cuh", "rules_warp.cuh"]
    for k, shared in ((kernels.RULES_STEP, warp),
                      (kernels.STATE_VIEWS, warp),
                      (kernels.SCRIPT_STEP, warp),
                      (kernels.RANDOM_STEP, warp),
                      (kernels.AGENT_STEPS, warp),
                      (kernels.CONV3X3_I8, ["conv_tc.cuh",
                                            "conv_i8_wide.cuh"]),
                      (kernels.CONV3X3_BF16, ["conv_tc.cuh"]),
                      (kernels.STEM_BF16, ["conv_tc.cuh"])):
        assert [h.name for h in k.headers] == shared
        for i, name in enumerate(shared):
            before = k.library
            copy = tmp_path / name
            copy.write_text(k.headers[i].read_text() + "\n// edited\n")
            headers = list(k.headers)
            headers[i] = copy
            monkeypatch.setattr(k, "headers", tuple(headers))
            assert k.library != before
            monkeypatch.undo()
    assert kernels.MCTS_DESCEND.headers == ()


def test_tensor_core_convs_export_the_tile_query():
    """Each tensor-core conv exports the block-shape query that
    ``fast_infer.conv_tile`` asks."""
    from alphazero_risk_tpu_torch import kernels
    for k in (kernels.CONV3X3_I8, kernels.CONV3X3_BF16):
        assert f'extern "C" int {k.symbol}_boards(int B, int C' in \
            k.source.read_text()


def test_rules_kernel_tables_follow_the_topology():
    """The packed ``rd::Tables`` buffer holds topology.py's tables at the
    offsets the header declares."""
    import numpy as np
    from alphazero_risk_tpu_torch.env import rules, topology
    buf = rules.kernel_tables(torch.device("cpu")).numpy()
    adj = buf[:336].view("<u8")
    for i in range(42):
        want = sum(1 << j for j in range(42) if topology.ADJACENCY[i, j])
        assert int(adj[i]) == want
    conts = buf[336:384].view("<u8")
    assert [bin(int(c)).count("1") for c in conts] == \
        topology.CONTINENT_SIZE.tolist()
    cards = buf[384:408].view("<u8")
    for c, t in zip(cards, (topology.CARD_INFANTRY, topology.CARD_HORSE,
                            topology.CARD_SIEGE)):
        assert int(c) == sum(1 << j for j in range(42) if t[j])
    ints = buf[408:736].view("<i4")
    np.testing.assert_array_equal(ints[12:76], rules.CARD_SET_GAIN)
    np.testing.assert_array_equal(ints[76:82], topology.CONTINENT_TIE_RANK)
    np.testing.assert_array_equal(buf[736:2500].view("<i1").reshape(42, 42),
                                  topology.NEIGHBOR_RANK)
    np.testing.assert_array_equal(buf[2500:].view("<i1").reshape(6, 42),
                                  topology.SCRIPT_LAND_RANK)
    text = (rules.kernels.CSRC / "rules_dev.cuh").read_text()
    assert "sizeof(Tables) == 2752" in text


def test_rules_kernel_tables_need_a_symmetric_adjacency(monkeypatch):
    """K7 and K8 test "land j neighbours land i" on j's own adjacency row
    (``csrc/rules_warp.cuh``), so packing the tables refuses a board whose
    adjacency is not symmetric."""
    import numpy as np
    from alphazero_risk_tpu_torch.env import rules, topology
    adj = np.array(topology.ADJACENCY, bool)
    adj[0, 41] = not adj[41, 0]
    monkeypatch.setattr(topology, "ADJACENCY", adj)
    with pytest.raises(AssertionError, match="symmetric"):
        rules.kernel_tables.__wrapped__(torch.device("cpu"))


def test_rules_kernel_flags_follow_each_config():
    """The rules kernels' trailing ints, cached by Config object: each
    switch sets its bit, and a cached entry answers only for its own
    (frozen) Config."""
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.env import rules
    base = Config()
    names = ("allow_yield", "limit_reinforcement_moves", "limit_attack_moves",
             "fast_attack_mobilization", "exact_fortify_tiebreak")
    want = sum(1 << i for i, n in enumerate(names) if getattr(base, n))
    assert rules.kernel_flags(base) == (base.land_army_max,
                                        base.min_unit_move,
                                        base.max_game_rounds, want)
    assert rules.kernel_flags(base) is rules.kernel_flags(base)
    for i, n in enumerate(names + ("simple_cards",)):
        other = base.replace(**{n: not getattr(base, n)})
        assert rules.kernel_flags(other)[3] == want ^ (1 << i)
    small = base.replace(land_army_max=7, min_unit_move=2,
                         max_game_rounds=99)
    assert rules.kernel_flags(small)[:3] == (7, 2, 99)
    assert rules.kernel_flags(base)[3] == want


@pytest.mark.parametrize("name", ["conv3x3_i8", "conv3x3_bf16", "heads_eval",
                                  "write_nodes", "rules_step", "expand",
                                  "state_views", "featurize", "script_step",
                                  "script_steps", "random_step",
                                  "random_steps", "backup"])
def test_cuda_tensor_wrappers_do_not_fall_back(name, monkeypatch):
    """A wrapper takes its plain version only for CPU tensors: with a
    tensor that claims another device it goes to the kernel path, which
    here (no card, no nvcc) raises instead of computing the plain
    version."""
    from alphazero_risk_tpu_torch.agents import blocks as AB
    from alphazero_risk_tpu_torch.agents import random_agent as RA
    from alphazero_risk_tpu_torch.agents import script_agent as SA
    from alphazero_risk_tpu_torch.config import Config
    from alphazero_risk_tpu_torch.env import featurize as FZ
    from alphazero_risk_tpu_torch.env import rules
    from alphazero_risk_tpu_torch.env.state import new_game, tree_map
    from alphazero_risk_tpu_torch.mcts import search as S
    from alphazero_risk_tpu_torch.models import fast_infer as FI

    meta = torch.device("meta")
    cfg = Config()
    st = tree_map(lambda t: t.to(meta), new_game(2, device="cpu"))
    i2 = torch.zeros(2, dtype=torch.int32, device=meta)
    u = torch.zeros((2, 4), device=meta)
    dice = torch.ones((2, 5), dtype=torch.int32, device=meta)
    if name == "rules_step":
        call = lambda: rules.step(st, i2, dice, cfg)
    elif name == "expand":
        nodes = tree_map(lambda t: t[:, None], st)
        call = lambda: rules.expand(nodes, i2, i2, i2, cfg)
    elif name == "state_views":
        call = lambda: rules.state_views(st, cfg, legal=True, status=True)
    elif name == "featurize":
        call = lambda: FZ.featurize(st, cfg)
    elif name == "script_step":
        carry = tree_map(lambda t: t.to(meta), SA.init_carry(2, "cpu"))
        call = lambda: SA.script_step_recorded(
            st, carry, torch.ones(2, dtype=torch.bool, device=meta), u,
            dice, cfg)
    elif name in ("script_steps", "random_steps"):
        carry = tree_map(lambda t: t.to(meta), SA.init_carry(2, "cpu"))
        kind = AB.OPP_SCRIPT if name == "script_steps" else AB.OPP_RANDOM
        call = lambda: AB.agent_steps(st, carry, i2, u[None], dice[None],
                                      cfg, (AB.OPP_AZ, kind))
    elif name == "backup":
        cfg = Config(mcts_simulations=2)
        tree = S._empty_tree(new_game(2, device="cpu"), cfg)
        tree.visit = tree.visit.to(meta)
        path = S.Descent(*(torch.zeros((2, cfg.max_depth), dtype=torch.int32,
                                       device=meta),) * 3,
                         *(i2,) * 5)
        call = lambda: S.backup(tree, path, u[:, 0], i2)
    elif name == "random_step":
        call = lambda: RA.random_step_recorded(st, u, dice, cfg)
    elif name == "conv3x3_i8":
        q = torch.empty((2, 7, 6, 64), dtype=torch.int8, device=meta)
        w = torch.empty((3, 3, 64, 64), dtype=torch.int8, device=meta)
        f = torch.empty(64, device=meta)
        call = lambda: FI.conv3x3_i8(q, w, f, f, torch.empty((), device=meta))
    elif name == "conv3x3_bf16":
        x = torch.empty((2, 7, 6, 13), device=meta)
        w = torch.empty((3, 3, 13, 64), dtype=torch.bfloat16, device=meta)
        call = lambda: FI.conv3x3_bf16(x, w, torch.empty(64, device=meta))
    elif name == "heads_eval":
        folded = {k: torch.empty(1, device=meta) for k in FI._HEAD_SHAPES}
        folded["heads_pack"] = torch.empty(
            FI.heads_layout(64, 1)["end"], device=meta)
        call = lambda: FI.heads_eval(
            folded, torch.empty((2, 42, 64), device=meta),
            torch.empty((2, 43), dtype=torch.bool, device=meta))
    else:
        cfg = Config(mcts_simulations=2)
        root = new_game(2, device="cpu")
        tree = S._empty_tree(root, cfg)
        tree.visit = tree.visit.to(meta)
        args = S.root_inputs(root, cfg, lambda s, m: (
            m.float(), torch.zeros(s.batch_size)))
        call = lambda: S.write_nodes(tree, *args)
    monkeypatch.setattr(FI, "_conv3x3_bf16_plain", None)
    monkeypatch.setattr(FI, "_conv_i8_plain", None)
    monkeypatch.setattr(FI, "_epilogue_plain", None)
    monkeypatch.setattr(FI, "_heads_eval_plain", None)
    monkeypatch.setattr(S, "_write_nodes_plain", None)
    for fn in ("_step_plain", "_step_with_outcome_plain", "_expand_plain",
               "_state_views_plain", "_legal_actions_plain",
               "_game_status_plain"):
        monkeypatch.setattr(rules, fn, None)
    monkeypatch.setattr(FZ, "_featurize_plain", None)
    monkeypatch.setattr(SA, "_script_step_recorded_plain", None)
    monkeypatch.setattr(AB, "_agent_steps_plain", None)
    monkeypatch.setattr(S, "_backup_plain", None)
    monkeypatch.setattr(RA, "_random_step_recorded_plain", None)
    with pytest.raises((ValueError, RuntimeError)):
        call()
