"""``levels_off``: the number of levels whose size differs from the rule
the parameters name (an exact comparison: limit 0).

``{"rule": "grid_blocks", "block", "max_coarse", "max_levels"}``:
aggregation by ``block``-wide blocks of the configuration's grid, a level
coarsened while it has more than ``max_coarse`` rows and fewer than
``max_levels`` levels exist."""

import numpy as np


def grid_block_sizes(grid, block, max_coarse, max_levels):
    grid = [int(g) for g in grid]
    sizes = [int(np.prod(grid))]
    while len(sizes) < max_levels and sizes[-1] > max_coarse:
        grid = [-(-g // block) for g in grid]
        sizes.append(int(np.prod(grid)))
    return sizes


def compare(rule, evidence):
    if rule["rule"] != "grid_blocks":
        raise ValueError(f"unknown level rule {rule['rule']!r}")
    want = grid_block_sizes(evidence.config["operator"]["grid"],
                            rule["block"], rule["max_coarse"],
                            rule["max_levels"])
    got = list(evidence.level_sizes)
    off = sum(a != b for a, b in zip(want, got)) + abs(len(want) - len(got))
    return {"levels_off": {"value": off, "limit": 0}}
