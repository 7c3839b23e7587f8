"""The run's check of loaded modules compares whole top-level names."""
import sys
import types

import pytest


@pytest.mark.parametrize("name,caught", [
    ("repro", True), ("repro.models", True), ("jax", True),
    ("jaxlib.xla", True), ("flax", True), ("repro_torch", False),
    ("repro_torchx", False), ("jaxtyping", False), ("reprox", False)])
def test_forbidden_modules(monkeypatch, name, caught):
    from pbench import runner
    before = runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = runner.forbidden_modules()
    top = name.split(".")[0]
    assert (top in found) == caught or top in before


def test_the_harness_loads_nothing_of_jax():
    """A fresh process that imports the harness, the reference and the
    port's modules the harness drives holds no jax or repro module."""
    import subprocess
    from conftest import BENCH, ROOT
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import pbench.runner, reference.model, reference.train\n"
            "import repro_torch.launch.steps, repro_torch.launch.serve\n"
            "import repro_torch.data\n"
            "from pbench import runner\n"
            "print(runner.forbidden_modules())" % (str(ROOT / "src"),
                                                   str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
