"""``{"kind": "diffusion_fv", "grid"}``: -div(k grad u) by finite volumes,
a face's coefficient the harmonic mean of its two cells' k, a Dirichlet
boundary face's the cell's own k; k is the traffic mix's coefficient
field, and k = 1 everywhere gives gallery.poisson exactly."""

import torch

from . import assemble, inside

FIELD = True


def build(spec, dtype, device, field):
    grid = tuple(int(g) for g in spec["grid"])
    k = field
    d = len(grid)
    deltas, off = [(0,) * d], []
    diag = torch.zeros_like(k)
    for axis in range(d):
        for step in (-1, 1):
            delta = tuple(step if a == axis else 0 for a in range(d))
            nb = torch.roll(k, shifts=-step, dims=axis)
            face = 2.0 * k * nb / (k + nb)
            diag += torch.where(inside(delta, grid, k.device), face, k)
            deltas.append(delta)
            off.append(-face)
    return assemble(grid, deltas, [diag] + off, dtype, k.device)
