"""Seeded fields: the numbers a traffic mix draws for each request.

A field spec is ``{"kind": <name>, ...}``; the kind is the module
``fields/<name>.py``, whose ``draw(spec, shape, seed, stream, index,
device)`` returns a float64 tensor of ``shape`` on ``device``, made from
``(seed, stream, index)`` alone, so that a seed gives the same numbers on
every run.  A new kind of field is a new file here.
"""

from __future__ import annotations

import importlib

import numpy as np

# the streams of one seed: x* of a request, the coefficients of an
# operator, the reservoir's picks, the check's probe vectors
SOLUTION, COEFFICIENTS, SAMPLE, PROBES = 0, 1, 2, 3


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed drawn from ``seed`` and ``keys`` (any whole numbers)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64]
                                + [int(k) % 2 ** 64 for k in keys])
    lo, hi = ss.generate_state(2, dtype=np.uint32)
    return (int(hi) << 31) ^ int(lo)


def kind(spec) -> str:
    """A spec's kind; a bare string is a kind with no parameters."""
    return spec if isinstance(spec, str) else spec["kind"]


def draw(spec, shape, seed: int, stream: int, index: int, device):
    """The field ``spec`` of request or operator ``index``."""
    mod = importlib.import_module(f"amgbench.fields.{kind(spec)}")
    return mod.draw({} if isinstance(spec, str) else spec, tuple(shape),
                    seed, stream, index, device)
