"""Exact battle-outcome distributions for chance-node MCTS.

The reference samples dice inside every tree traversal and merges repeats via
a state-keyed transposition table (alphazero_mcts.cpp:322-377) — value
estimates average over dice only through repeated sampling.  Both packages
use the closed form: a max-dice battle has at most 3 distinct outcomes (number of
attacker losses in [0, ncomp]) whose probabilities depend only on
(att_n in 1..3, def_n in 1..2).  Search samples outcomes from these exact
probabilities, which dominates the reference's estimator at equal simulation
count.

Table built by enumeration over all dice combinations (d6); a copy of
``alphazero_risk_tpu/mcts/outcomes.py``.
"""

from __future__ import annotations

import itertools

import numpy as np

# OUTCOME_PROBS[att_n-1, def_n-1, o] = P(attacker loses o units),
# o in {0, 1, 2}; impossible outcomes have probability 0.
OUTCOME_PROBS = np.zeros((3, 2, 3), np.float64)

for _att_n in (1, 2, 3):
    for _def_n in (1, 2):
        counts = np.zeros(3, np.int64)
        total = 0
        for att in itertools.product(range(1, 7), repeat=_att_n):
            a_sorted = sorted(att, reverse=True)
            for dfn in itertools.product(range(1, 7), repeat=_def_n):
                d_sorted = sorted(dfn, reverse=True)
                losses = 0 if a_sorted[0] > d_sorted[0] else 1
                if _att_n >= 2 and _def_n == 2:
                    losses += 0 if a_sorted[1] > d_sorted[1] else 1
                counts[losses] += 1
                total += 1
        OUTCOME_PROBS[_att_n - 1, _def_n - 1] = counts / total

OUTCOME_PROBS.setflags(write=False)

# Classic checks (e.g. 3v2: win both 2890/7776, split 2611/7776,
# lose both 2275/7776).
assert abs(OUTCOME_PROBS[2, 1, 0] - 2890 / 7776) < 1e-12
assert abs(OUTCOME_PROBS[2, 1, 1] - 2611 / 7776) < 1e-12
assert abs(OUTCOME_PROBS[2, 1, 2] - 2275 / 7776) < 1e-12
assert abs(OUTCOME_PROBS[0, 0, 0] - 15 / 36) < 1e-12
