"""``{"kind": "normal"}``: standard normal numbers from a generator on the
device, seeded from ``(seed, stream, index)``."""

import torch

from . import stream_seed


def draw(spec, shape, seed, stream, index, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream, index))
    return torch.randn(shape, generator=gen, dtype=torch.float64,
                       device=device)
