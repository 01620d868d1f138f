"""``{"kind": "fourier_lognormal", "modes", "contrast"}``: k = exp(s g) on
a grid, g a sum of ``modes`` cosines with integer wave vectors of at most
3 per axis, normal amplitudes and uniform phases drawn from ``(seed,
stream, index)``, s such that max k / min k = ``contrast``."""

import numpy as np
import torch

from . import stream_seed


def draw(spec, shape, seed, stream, index, device):
    rng = np.random.default_rng(stream_seed(seed, stream, index))
    d = len(shape)
    coords = [torch.arange(g, dtype=torch.float64, device=device) / g
              for g in shape]
    mesh = torch.meshgrid(*coords, indexing="ij")
    g = torch.zeros(shape, dtype=torch.float64, device=device)
    for _ in range(int(spec["modes"])):
        wave = rng.integers(0, 4, size=d)
        if not wave.any():
            wave[rng.integers(0, d)] = 1
        amp, phase = rng.standard_normal(), rng.uniform(0, 2 * np.pi)
        arg = sum(float(w) * c for w, c in zip(wave, mesh))
        g += amp * torch.cos(2 * np.pi * arg + phase)
    span = torch.clamp(g.max() - g.min(), min=1e-300)
    return torch.exp(np.log(float(spec["contrast"])) * (g - g.min()) / span)
