"""The port's public surface against the JAX package's.

Every name of the reference API table (``tests/test_api_surface.py``) and
of each package's ``__all__`` in ``pyamg_tpu`` resolves at the same place
in ``pyamg_tpu_torch`` (``pyamg_tpu`` renamed), except the names in
``TO_PORT``: each is keyed to the ROADMAP.md item that ports it (a bold
Queue 1 name, or "Not ported by design"), and is checked to be still
missing, so that the set shrinks as the items land.  One case per name.

Then the legacy cost keywords of the work models: both packages accept
and ignore them with a ``DeprecationWarning`` and give the same result.
"""

import importlib
import pkgutil
import warnings
from pathlib import Path

import pytest

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu import complexity as jax_complexity
import pyamg_tpu_torch
from pyamg_tpu_torch import complexity
from pyamg_tpu_torch.gallery import poisson

from test_api_surface import REFERENCE_SURFACE

ROADMAP = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()

BY_DESIGN = "Not ported by design"

# (reference module, name) -> the ROADMAP.md item that ports it
TO_PORT = {
    ("pyamg_tpu.util", "pinv_array_jax"): BY_DESIGN,
}


def _reference_names():
    """Sorted ``(module, name)`` of the reference table and of the
    ``__all__`` of ``pyamg_tpu`` and each of its packages."""
    table = {(m, n) for m, names in REFERENCE_SURFACE.items()
             for n in names}
    packages = ["pyamg_tpu"] + [f"pyamg_tpu.{p.name}" for p in
                                pkgutil.iter_modules(pyamg_tpu.__path__)
                                if p.ispkg]
    for m in packages:
        table |= {(m, n) for n in importlib.import_module(m).__all__}
    return sorted(table)


NAMES = _reference_names()


def _port(module):
    try:
        return importlib.import_module(
            module.replace("pyamg_tpu", "pyamg_tpu_torch", 1))
    except ModuleNotFoundError:
        return None


@pytest.mark.parametrize("module,name", NAMES,
                         ids=[f"{m}.{n}" for m, n in NAMES])
def test_reference_name_resolves_in_the_port(module, name):
    item = TO_PORT.get((module, name))
    port = _port(module)
    if item is None:
        assert port is not None and hasattr(port, name), \
            f"{module}.{name} is not at its place in the port"
        return
    marker = "**Not ported by design**" if item == BY_DESIGN \
        else f"**{item}**"
    assert marker in ROADMAP, f"{item!r} is no ROADMAP.md item"
    assert port is None or not hasattr(port, name), \
        f"{module}.{name} is ported now: take it out of TO_PORT"


def test_every_name_still_to_port_is_a_reference_name():
    assert set(TO_PORT) <= set(NAMES)


LEGACY = dict(strength_cost=1.0, aggregation_cost=2.0, presmoother_cost=3.0,
              postsmoother_cost=4.0, smooth_cost=5.0,
              improve_candidates_cost=6.0)


@pytest.mark.parametrize("fn", ["setup_complexity", "cycle_complexity"])
def test_legacy_cost_keywords_warn_as_in_the_jax_package(fn, monkeypatch):
    A = poisson((16, 16), format="csr")
    J = A.copy()
    J.grid = A.grid
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, max_coarse=10,
                                                       device="cpu")
    monkeypatch.setattr(jax_core, "have_native", lambda: True)
    ref = pyamg_tpu.smoothed_aggregation_solver(J, max_coarse=10)
    results, caught = [], []
    for module, ml in ((complexity, ours), (jax_complexity, ref)):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            results.append(getattr(module, fn)(ml, **LEGACY))
        legacy = [w for w in seen if "deprecated" in str(w.message)]
        assert len(legacy) == 1, [str(w.message) for w in seen]
        caught.append((legacy[0].category, str(legacy[0].message)))
        assert getattr(module, fn)(ml) == results[-1]
    assert caught[0] == caught[1]
    assert caught[0][0] is DeprecationWarning
    assert results[0] == pytest.approx(results[1], rel=1e-14)
    with pytest.raises(TypeError, match="unexpected"):
        getattr(complexity, fn)(ours, no_such_cost=1.0)
