"""AlphaZero residual network for the 7x6 Risk board image: its
parameters and buffers, by the names and shapes of the port's
``models/resnet.py``.

A 3x3 conv + BN stem, N residual blocks [conv-BN-ReLU-conv-BN-add-ReLU], a
2-filter policy head to 43 logits and a 1-filter value head through a dense
hidden layer to tanh; BatchNorm with Flax's eps 1e-3.  The benchmark only
folds these parameters into its own inference network
(``models/fast_infer.py``), so no forward is kept here.
"""

from __future__ import annotations

from torch import nn

from ..config import NUM_ACTIONS


class ResBlock(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.conv_a = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn_a = nn.BatchNorm2d(filters, eps=1e-3, momentum=0.01)
        self.conv_b = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn_b = nn.BatchNorm2d(filters, eps=1e-3, momentum=0.01)


class AZNet(nn.Module):
    """Policy/value network parameters (``models/fast_infer.py`` folds
    them)."""

    def __init__(self, blocks: int = 20, filters: int = 256,
                 value_hidden: int = 256, num_features: int = 13):
        super().__init__()
        self.stem_conv = nn.Conv2d(num_features, filters, 3, padding=1,
                                   bias=False)
        self.stem_bn = nn.BatchNorm2d(filters, eps=1e-3, momentum=0.01)
        self.blocks = nn.ModuleList(ResBlock(filters) for _ in range(blocks))
        self.policy_conv = nn.Conv2d(filters, 2, 1, bias=False)
        self.policy_bn = nn.BatchNorm2d(2, eps=1e-3, momentum=0.01)
        self.policy_dense = nn.Linear(2 * 42, NUM_ACTIONS)
        self.value_conv = nn.Conv2d(filters, 1, 1, bias=False)
        self.value_bn = nn.BatchNorm2d(1, eps=1e-3, momentum=0.01)
        self.value_dense1 = nn.Linear(42, value_hidden)
        self.value_dense2 = nn.Linear(value_hidden, 1)
        self.eval()
