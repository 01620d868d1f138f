"""The comparison that decides ``correct``.

A configuration's ``checks`` maps each check's name to its parameters;
the name is the module ``checks/<name>.py`` here, whose ``compare(params,
evidence)`` gives the numbers it compares, each ``{"value", "limit"}``
(a number is within its limit when it is at most the limit, or, with
``"at_least"``, at least it).  Two numbers are compared in every run:
``failed``, the window's requests that raised or gave no answer (limit
0), and ``checked``, the requests compared (at least 1).  A new check is
a new file here and a key in the configuration.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field


@dataclass
class Evidence:
    """What a run hands the reference once the window has closed.

    ``samples``: ``(operator, x_star, x)`` of the checked requests, the
    reference's own operator of each request and host float64 arrays;
    ``level_sizes``: the rows of each level of the hierarchy;
    ``hierarchy``: where a check asks for it, each level's ``A``, ``P`` and
    ``R`` read back from the program (``P`` and ``R`` as lists of
    factors of ``matrices.host`` items); ``probe_seed``: a seed for the
    checks' own random vectors."""
    config: dict
    samples: list = field(default_factory=list)
    level_sizes: list = field(default_factory=list)
    hierarchy: list | None = None
    failed: int = 0
    probe_seed: int = 0


def wants_hierarchy(config: dict) -> bool:
    return any(getattr(_module(name), "HIERARCHY", False)
               for name in config["checks"])


def _module(name):
    return importlib.import_module(f"amgbench.reference.checks.{name}")


def within(num) -> bool:
    v, lim = num["value"], num["limit"]
    if v is None or v != v:
        return False
    return v >= lim if num.get("at_least") else v <= lim


def compare(evidence: Evidence):
    """``(correct, numbers)``: ``numbers`` maps each compared name to
    ``{"value", "limit"}``."""
    numbers = {}
    for name, params in evidence.config["checks"].items():
        numbers.update(_module(name).compare(params, evidence))
    numbers["failed"] = {"value": int(evidence.failed), "limit": 0}
    numbers["checked"] = {"value": len(evidence.samples), "limit": 1,
                          "at_least": True}
    return all(within(n) for n in numbers.values()), numbers
