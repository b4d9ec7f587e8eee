"""The port's CUDA kernels against their plain versions, on the card.

Skipped without an NVIDIA card.  Imports nothing of JAX, so it also runs
where JAX is not installed (skipping the repo's conftest, which is):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from alphazero_risk_tpu_torch import kernels
from alphazero_risk_tpu_torch.config import Config
from alphazero_risk_tpu_torch.env import rules
from alphazero_risk_tpu_torch.env.state import GameState, new_game, tree_map
from alphazero_risk_tpu_torch.models import fast_infer as FI
from alphazero_risk_tpu_torch.mcts import search as S
from alphazero_risk_tpu_torch.training import actor as A
from alphazero_risk_tpu_torch.training.trainer import Trainer

pytestmark = pytest.mark.cuda


def played_roots(batch, steps, seed):
    cfg = Config()
    gen = torch.Generator().manual_seed(seed)
    st = new_game(batch, generator=gen, device="cpu")
    for _ in range(steps):
        legal = rules.legal_actions(st, cfg)
        g = torch.rand(legal.shape, generator=gen)
        st = rules.step_key(st, torch.argmax(torch.where(legal, g, -1.0), -1)
                            .to(torch.int32), gen, cfg)
    return st


def uniform_eval(state, legal):
    probs = legal.float() / legal.sum(-1, keepdim=True)
    own = state.owner == state.cur_player[:, None]
    return probs, (own.sum(-1) % 5 - 2).float() / 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _to(tree, dev):
    return type(tree)(**{
        f.name: (tree_map(lambda x: x.to(dev), getattr(tree, f.name))
                 if isinstance(getattr(tree, f.name), GameState)
                 else getattr(tree, f.name).to(dev))
        for f in dataclasses.fields(tree)})


def test_conv3x3_i8_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randint(-127, 128, (8, 7, 6, 128), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, 128, 128), generator=g, device=cuda,
                      dtype=torch.int8)
    ws = torch.rand(128, generator=g, device=cuda) / 127
    b = torch.randn(128, generator=g, device=cuda)
    s = torch.tensor(0.01, device=cuda)
    res = torch.randn((8, 7, 6, 128), generator=g, device=cuda)
    inv = torch.tensor(1 / 3.0, device=cuda)
    h, qn, acc = FI.conv3x3_i8(q, w, ws, b, s, residual=res, inv_s_next=inv,
                               want_acc=True)
    ref_acc = FI._conv_i8_plain(q, w)
    ref_h, ref_q = FI._epilogue_plain(ref_acc, ws, b, s, res, inv)
    assert torch.equal(acc, ref_acc)
    torch.testing.assert_close(h, ref_h, rtol=1e-6, atol=1e-6)
    assert int((qn.int() - ref_q.int()).abs().max()) <= 1


def test_descend_and_backup_match_plain(cuda):
    cfg = Config(mcts_simulations=6, max_depth=10)
    root = played_roots(64, 120, seed=3)
    gum = S.draw_gumbel(torch.Generator().manual_seed(1), cfg, 64, "cpu")
    tree = _to(S.search(root, gum, cfg, uniform_eval).tree, cuda)
    g0 = gum[0].to(cuda)
    path = S.descend(tree, g0, cfg)
    for a, r in zip(path, S._descend_plain(tree, g0, cfg)):
        assert torch.equal(a, r)
    leaf_v = torch.linspace(-1, 1, 64, device=cuda)
    leaf_p = tree.player[torch.arange(64, device=cuda), path.cur.long()]
    visit, wsum = tree.visit.clone(), tree.wsum.clone()
    S.backup(tree, path, leaf_v, leaf_p)
    kv, kw = tree.visit.clone(), tree.wsum.clone()
    tree.visit.copy_(visit)
    tree.wsum.copy_(wsum)
    S._backup_plain(tree, path, leaf_v, leaf_p)
    assert torch.equal(kv, tree.visit)
    torch.testing.assert_close(kw, tree.wsum, rtol=1e-6, atol=0)


def test_play_launches_every_kernel(cuda):
    cfg = Config(blocks=2, filters=64, value_hidden=16, mcts_simulations=4,
                 max_depth=8, env_batch_per_device=4, fast_infer=True,
                 fast_infer_int8=True)
    trainer = Trainer(cfg, seed=0, device=cuda)
    kernels.reset_counts()
    res = trainer.play(A.OPP_SCRIPT, 4)
    assert res["unfinished"] == 0
    assert all(n > 0 for n in kernels.counts().values()), kernels.counts()
