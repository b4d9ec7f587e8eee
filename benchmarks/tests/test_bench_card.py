"""Card tests of the reference: its integer conv on the card (an im2col
matrix through ``torch._int_mm``) against the exact float64 conv."""

import pytest
import torch

from benchmarks.reference.models import fast_infer as ref_fast


@pytest.fixture
def card():
    """The card, decided inside the test (``--noconftest`` runs on the
    card load no conftest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 33, 1024])
def test_int_conv_on_card_is_exact(card, batch):
    g = torch.Generator()
    g.manual_seed(batch)
    q = torch.randint(-127, 128, (batch, 7, 6, 256), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, 256, 256), generator=g,
                      dtype=torch.int8)
    want = ref_fast.int_conv(q, w)
    got = ref_fast.int_conv(q.to(card), w.to(card)).cpu()
    assert torch.equal(got, want)
