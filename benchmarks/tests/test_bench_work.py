"""The work counts against the hand counts."""

import json

import pytest

from benchmarks import harness, work


def _cfg(name):
    return json.loads((harness.ROOT / "benchmarks/configs" / f"{name}.json")
                      .read_text())


def test_trunk_by_hand():
    # 40 convs of 42 positions x 9 taps x 256 x 256 multiply-adds
    assert work.trunk_flops(_cfg("az20x256")) == 2 * 40 * 42 * 9 * 256 * 256
    assert work.trunk_flops(_cfg("az5x256")) == 2 * 10 * 42 * 9 * 256 * 256


@pytest.mark.parametrize("name,gflop", [("az20x256", 1.982),
                                        ("az5x256", 0.498)])
def test_forward_per_board(name, gflop):
    cfg = _cfg(name)
    total = work.forward_flops(cfg)
    # the trunk, a stem of 2.5 MFLOP and heads of under 0.1 MFLOP
    assert work.stem_flops(cfg) == 2 * 42 * 9 * 13 * 256 == 2_515_968
    assert work.heads_flops(cfg) < 1e5
    assert abs(total / 1e9 - gflop) < 0.003


def test_least_time_bounds():
    cfg = _cfg("az20x256")
    t = work.eval_least_seconds(cfg, 1024)
    assert t > 1024 * work.trunk_flops(cfg) / work.PEAK["int8_ops"]
    assert t < 2 * 1024 * work.trunk_flops(cfg) / work.PEAK["int8_ops"]
