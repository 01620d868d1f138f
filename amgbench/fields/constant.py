"""``{"kind": "constant", "value": v}``: v everywhere."""

import torch


def draw(spec, shape, seed, stream, index, device):
    return torch.full(shape, float(spec["value"]), dtype=torch.float64,
                      device=device)
