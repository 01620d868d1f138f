"""Nothing a run imports is JAX or the JAX package, compared by whole
top-level names; the reference imports nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "pyamg_tpu"}


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_every_module_and_the_program():
    mods = ["amgbench." + ".".join(p.relative_to(ROOT / "amgbench")
                                   .with_suffix("").parts)
            for p in (ROOT / "amgbench").rglob("*.py")
            if "tests" not in p.parts and p.name != "__init__.py"]
    code = "\n".join(["import sys", f"sys.path.insert(0, {str(ROOT)!r})",
                      "import pyamg_tpu_torch, pyamg_tpu_torch.parallel",
                      "import pyamg_tpu_torch.aggregation.device_setup"]
                     + [f"import {m}" for m in mods])
    loaded = loaded_after(code)
    assert "pyamg_tpu_torch" in loaded and "amgbench" in loaded
    assert not loaded & FORBIDDEN


def test_whole_name_compare(monkeypatch):
    import types

    from amgbench.harness import forbidden_modules

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pyamg_tpu_torch_like.sub",
                        types.ModuleType("pyamg_tpu_torch_like.sub"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pyamg_tpu.sparse",
                        types.ModuleType("pyamg_tpu.sparse"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert forbidden_modules() == ["jax", "pyamg_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = "\n".join(["import sys", f"sys.path.insert(0, {str(ROOT)!r})",
                      "import amgbench.reference.checks.galerkin",
                      "import amgbench.reference.checks.levels",
                      "import amgbench.reference.checks.relres",
                      "import amgbench.reference.diffusion_fv",
                      "import amgbench.reference.stencil"])
    loaded = loaded_after(code)
    assert not loaded & (FORBIDDEN | {"pyamg_tpu_torch", "torch"})
