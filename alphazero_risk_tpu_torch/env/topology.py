"""Static Risk board topology as dense NumPy constants.

The reference encodes the 42-territory graph as per-territory ``uint64``
bitmasks (reference: ``src/risk_game/land/land.cpp:246-313``,
``land_set.cpp:10-38``).  Here the same facts are dense NumPy arrays, a
copy of ``alphazero_risk_tpu/env/topology.py`` kept beside the port so that
it imports nothing of the JAX package: a ``[42, 42]`` boolean adjacency matrix, a
``[6, 42]`` continent membership matrix, and rank tables that preserve the
reference's *iteration orders* (used for deterministic tie-breaking).

Territory indices follow the reference enum exactly
(``src/risk_game/land/land_index.h:12-70``).
"""

from __future__ import annotations

import numpy as np

NUM_LANDS = 42

# Names (index == reference LandIndex value).
LAND_NAMES = [
    "ALASKA", "NORTHWEST_TERRITORY", "GREENLAND", "ALBERTA", "ONTARIO",
    "QUEBEC", "WESTERN_UNITED_STATES", "EASTERN_UNITED_STATES",
    "CENTRAL_AMERICA",
    "VENEZUELA", "PERU", "BRAZIL", "ARGENTINA",
    "ICELAND", "GREAT_BRITAIN", "SCANDINAVIA", "UKRAINE", "NORTHERN_EUROPE",
    "SOUTHERN_EUROPE", "WESTERN_EUROPE",
    "NORTH_AFRICA", "EGYPT", "CONGO", "EAST_AFRICA", "SOUTH_AFRICA",
    "MADAGASCAR",
    "URAL", "SIBERIA", "YAKUTSK", "KAMCHATKA", "IRKUTSK", "JAPAN", "MONGOLIA",
    "AFGHANISTAN", "CHINA", "MIDDLE_EAST", "INDIA", "SIAM",
    "INDONESIA", "NEW_GUINEA", "WESTERN_AUSTRALIA", "EASTERN_AUSTRALIA",
]

# Neighbour lists in the reference's declaration order
# (reference: land.cpp:246-297).  Order matters: the reference picks the
# "first strict maximum" while iterating these lists, so the per-edge rank
# below reproduces its tie-breaking.
NEIGHBORS = [
    [1, 3, 29],             # ALASKA
    [0, 3, 4, 2],           # NORTHWEST_TERRITORY
    [1, 4, 5, 13],          # GREENLAND
    [0, 1, 4, 6],           # ALBERTA
    [1, 3, 6, 7, 5, 2],     # ONTARIO
    [4, 7, 2],              # QUEBEC
    [3, 4, 7, 8],           # WESTERN_UNITED_STATES
    [8, 6, 4, 5],           # EASTERN_UNITED_STATES
    [6, 7, 9],              # CENTRAL_AMERICA
    [8, 10, 11],            # VENEZUELA
    [9, 11, 12],            # PERU
    [9, 10, 12, 20],        # BRAZIL
    [10, 11],               # ARGENTINA
    [2, 14, 15],            # ICELAND
    [13, 19, 15, 17],       # GREAT_BRITAIN
    [13, 14, 16, 17],       # SCANDINAVIA
    [15, 17, 18, 35, 33, 26],  # UKRAINE
    [15, 14, 18, 19, 16],   # NORTHERN_EUROPE
    [19, 17, 16, 20, 21, 35],  # SOUTHERN_EUROPE
    [20, 14, 18, 17],       # WESTERN_EUROPE
    [11, 19, 18, 21, 23, 22],  # NORTH_AFRICA
    [18, 20, 23, 35],       # EGYPT
    [20, 23, 24],           # CONGO
    [21, 20, 22, 24, 25, 35],  # EAST_AFRICA
    [22, 23, 25],           # SOUTH_AFRICA
    [24, 23],               # MADAGASCAR
    [16, 33, 34, 27],       # URAL
    [26, 34, 32, 30, 28],   # SIBERIA
    [27, 30, 29],           # YAKUTSK
    [28, 30, 32, 31, 0],    # KAMCHATKA
    [28, 29, 32, 27],       # IRKUTSK
    [29, 32],               # JAPAN
    [27, 30, 29, 31, 34],   # MONGOLIA
    [16, 26, 34, 36, 35],   # AFGHANISTAN
    [32, 27, 26, 33, 36, 37],  # CHINA
    [21, 23, 18, 16, 33, 36],  # MIDDLE_EAST
    [35, 33, 34, 37],       # INDIA
    [36, 34, 38],           # SIAM
    [37, 39, 40],           # INDONESIA
    [38, 41, 40],           # NEW_GUINEA
    [41, 39, 38],           # WESTERN_AUSTRALIA
    [40, 39],               # EASTERN_AUSTRALIA
]

MAX_DEGREE = 6

# Dense symmetric adjacency.
ADJACENCY = np.zeros((NUM_LANDS, NUM_LANDS), dtype=bool)
for _i, _ns in enumerate(NEIGHBORS):
    for _n in _ns:
        ADJACENCY[_i, _n] = True
assert (ADJACENCY == ADJACENCY.T).all(), "Risk adjacency must be symmetric"

ADJ_F32 = ADJACENCY.astype(np.float32)

# NEIGHBOR_RANK[i, j] = position of j in i's neighbour list, MAX_DEGREE if
# not adjacent.  Used to reproduce the reference's first-strict-max scans
# (e.g. best-attack-from, alphazero_moves.cpp:127-142).
NEIGHBOR_RANK = np.full((NUM_LANDS, NUM_LANDS), MAX_DEGREE, dtype=np.int32)
for _i, _ns in enumerate(NEIGHBORS):
    for _r, _n in enumerate(_ns):
        NEIGHBOR_RANK[_i, _n] = _r

# Padded neighbour-index table [42, MAX_DEGREE]: entry is the land itself
# where a slot is unused (safe identity for min/max reductions over
# neighbour-gathered values).
NEIGHBOR_IDX = np.empty((NUM_LANDS, MAX_DEGREE), dtype=np.int32)
for _i, _ns in enumerate(NEIGHBORS):
    for _j in range(MAX_DEGREE):
        NEIGHBOR_IDX[_i, _j] = _ns[_j] if _j < len(_ns) else _i

# Continents (reference: land_set.cpp:12-30, land_index.h:5-10).
CONTINENTS = {
    "NORTH_AMERICA": (list(range(0, 9)), 5),
    "SOUTH_AMERICA": (list(range(9, 13)), 2),
    "EUROPE": (list(range(13, 20)), 5),
    "AFRICA": (list(range(20, 26)), 3),
    "ASIA": (list(range(26, 38)), 7),
    "AUSTRALIA": (list(range(38, 42)), 2),
}
CONTINENT_NAMES = list(CONTINENTS)
NUM_CONTINENTS = len(CONTINENTS)

CONTINENT_MASK = np.zeros((NUM_CONTINENTS, NUM_LANDS), dtype=bool)
CONTINENT_BONUS = np.zeros((NUM_CONTINENTS,), dtype=np.int32)
for _c, (_name, (_lands, _bonus)) in enumerate(CONTINENTS.items()):
    CONTINENT_MASK[_c, _lands] = True
    CONTINENT_BONUS[_c] = _bonus
CONTINENT_SIZE = CONTINENT_MASK.sum(axis=1).astype(np.int32)

# The ScriptPlayer walks each continent's lands in the *declared* order of
# land_set.cpp (NOT ascending index): the first attackable land in this order
# becomes the attack target (script_player.cpp:39-50).
# SCRIPT_LAND_RANK[c, l] = position of land l in continent c's declared list,
# large if not a member.
_CONTINENT_DECLARED_ORDER = {
    "NORTH_AMERICA": [0, 1, 2, 3, 4, 5, 6, 7, 8],
    "SOUTH_AMERICA": [9, 10, 11, 12],
    "EUROPE": [13, 14, 15, 16, 17, 19, 18],
    "AFRICA": [20, 21, 22, 24, 25, 23],
    "ASIA": [26, 33, 35, 36, 27, 28, 29, 30, 31, 32, 34, 37],
    "AUSTRALIA": [38, 39, 40, 41],
}
SCRIPT_LAND_RANK = np.full((NUM_CONTINENTS, NUM_LANDS), NUM_LANDS,
                           dtype=np.int32)
for _c, _name in enumerate(CONTINENT_NAMES):
    for _r, _l in enumerate(_CONTINENT_DECLARED_ORDER[_name]):
        SCRIPT_LAND_RANK[_c, _l] = _r

# Tie-break order of continents when (notOwnedLands, notOwnedAttackLands) are
# equal: descending landSetIndexBitMask, i.e. descending highest land index
# (game_helper.cpp:19-36).  CONTINENT_TIE_RANK[c] smaller = preferred.
_HIGHEST_LAND = CONTINENT_MASK.argmax(axis=1) * 0  # placeholder
_highest = [max(lands) for lands, _ in CONTINENTS.values()]
CONTINENT_TIE_RANK = np.argsort(np.argsort([-h for h in _highest])).astype(
    np.int32)

# Card types (reference: land.cpp:299-310).  Unused when simple_cards=True.
CARD_INFANTRY = np.zeros(NUM_LANDS, dtype=bool)
CARD_INFANTRY[[0, 12, 22, 34, 23, 21, 13, 29, 35, 32, 39, 10, 37, 9]] = True
CARD_HORSE = np.zeros(NUM_LANDS, dtype=bool)
CARD_HORSE[[33, 3, 5, 2, 36, 30, 25, 20, 4, 16, 27, 26, 28]] = True
CARD_HORSE[15] = True
CARD_SIEGE = ~(CARD_INFANTRY | CARD_HORSE)

# Board-image coordinates: land l sits at (y, x) = (l // 6, l % 6) on the
# 7x6 grid fed to the network (reference: alphazero_nn.cpp:31-67).
MAP_Y, MAP_X = 7, 6
assert MAP_Y * MAP_X == NUM_LANDS
