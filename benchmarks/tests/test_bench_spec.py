"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re
import shutil

import pytest

from benchmarks import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|filters"
                   r"|_dim$|_rank$|head|expansion|per_tok)")


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmarks/run.py"]
    assert spec["paths"] == ["benchmarks"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024


def test_names_and_units(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert PATH.match(c["file"]) and c["file"].startswith("benchmarks/")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in spec[group]]
        assert len(group_names) == len(set(group_names))


def test_metrics_rules(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_spec()
                                  ["workloads"]])
def test_cell_resolves(spec, cell):
    c = harness.Cell(spec, cell)
    assert c.driver_file.exists()
    assert c.config["name"] == c.entry["config"]
    assert c.end_to_end and any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for f in c.metric_files.values():
        assert f.exists(), f


def test_new_cell_found_as_new_files(tmp_path, spec):
    """A cell added by new files and a new entry, with no edit of an
    existing file, is found and resolved."""
    root = tmp_path / "repo"
    shutil.copytree(harness.ROOT / "benchmarks", root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((root / "benchmarks/traffic/arena.b1024.json")
                         .read_text())
    traffic["games"] = 64
    (root / "benchmarks/traffic/arena.b64.json").write_text(
        json.dumps(traffic))
    (root / "benchmarks/metrics/launches.play.py").write_text(
        "def read(ctx):\n    return None\n")
    new = json.loads(json.dumps(spec))
    new["workloads"].append({"name": "az20.arena.b64", "config": "az20x256",
                             "traffic": "arena.b64", "chips": 1,
                             "why": "host-launch overhead"})
    new["per_layer"].append({"name": "launches.play", "unit": "ops",
                             "better": "lower", "source": "program_counter",
                             "layer": "kernels", "moves": "decisions_per_s",
                             "workloads": ["az20.arena.b64"]})
    for m in new["end_to_end"]:
        if m["name"] == "decisions_per_s":
            m["workloads"].append("az20.arena.b64")
    c = harness.Cell(new, "az20.arena.b64", root=root)
    assert c.traffic["games"] == 64
    assert c.driver_file == root / "benchmarks/drivers/play.py"
    assert [m["name"] for m in c.per_layer] == ["launches.play"]
    assert harness.read_metrics(c, {"counts": {}}) == {}


def test_config_files_record_source(spec):
    for c in spec["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg
