"""The plain reference: numpy and scipy only, nothing of the program.

``operator(op_spec, dtype, field)`` writes a configuration's operator
again from its definition: the module ``reference/<kind>.py`` of the
operator's kind.  ``checks/`` holds the comparisons that decide
``correct``, ``matrices.py`` the host forms of the program's matrices
they read."""

import importlib


def operator(op_spec: dict, dtype: str, field=None):
    """The reference operator of a configuration's ``operator`` entry
    (``field``: the host coefficient grid of a kind that takes one)."""
    mod = importlib.import_module(f"amgbench.reference.{op_spec['kind']}")
    return mod.operator(op_spec, dtype, field)
