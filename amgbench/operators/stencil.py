"""``{"kind": "stencil", "grid", "shape": "box" | "cross", "center",
"neighbor"}``: constant coefficients, every neighbour within distance 1
(``box``) or along one axis only (``cross``)."""

import torch

from . import assemble, stencil_offsets

FIELD = False


def build(spec, dtype, device, field=None):
    grid = tuple(int(g) for g in spec["grid"])
    deltas = stencil_offsets(len(grid), spec["shape"])
    values = [torch.full(grid, float(spec["center"] if not any(dd)
                                     else spec["neighbor"]),
                         dtype=torch.float64, device=device)
              for dd in deltas]
    return assemble(grid, deltas, values, dtype, device)
