"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py``, not ``tools/meshselect_sweep.py`` and no example twin
(``examples/*_torch.py``) imports JAX or the JAX package, or names one of
its modules in a string (which a later ``import_module`` could load); the
port's StreamFlow engine imports, loads a dict document and runs it
where neither JAX, the JAX package nor PyYAML can be imported; and the
smoke script refuses to run without a GPU."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tools" / "meshselect_sweep.py"] + \
    sorted((ROOT / "examples").glob("*_torch.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _forbidden(name):
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro", "flax", "optax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_nothing_of_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_were_found():
    names = {p.name for p in PORT_FILES}
    assert {"transformer.py", "ops.py", "serve.py", "pipeline.py",
            "chip_smoke.py", "train_e2e_torch.py",
            "serve_batched_torch.py"} <= names
    paths = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/core/executor.py",
            "src/repro_torch/core/connectors/mesh.py",
            "src/repro_torch/core/analyzer.py",
            "src/repro_torch/core/service.py", "src/repro_torch/cli.py",
            "src/repro_torch/configs/recovery_demo.py",
            "examples/lm_pipeline_torch.py", "examples/quickstart_torch.py",
            "examples/resume_after_crash_torch.py"} <= paths


# a string that is a module path of the JAX package, e.g. a builder module
# a document or a journal names and the engine imports later
JAX_MODULE_PATH = re.compile(r"^repro(\.\w+)+$")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_names_no_jax_package_module(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({node.value for node in ast.walk(tree)
                  if isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and JAX_MODULE_PATH.match(node.value)})
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('modules', sum(m.startswith('repro_torch') for m in sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_the_ports_engine_runs_without_jax_repro_or_yaml():
    """The chip machine's situation: neither JAX, the JAX package nor PyYAML
    can be imported.  The port's engine, its service, its CLI and the
    drill workflow import; the engine loads the hybrid document from a dict
    and runs it end to end on the CPU at the test size, and a
    ``WorkflowService`` runs one submission of it."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'yaml'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.core as core\n"
        "import repro_torch.cli, repro_torch.core.service\n"
        "import repro_torch.configs.recovery_demo\n"
        "from repro_torch import pipeline\n"
        "doc = pipeline.streamflow_doc_declarative_hybrid(\n"
        "    n_samples=3, rows_per_sample=4, seq_len=16, train_steps=1,\n"
        "    batch=2, vocab=64, d_model=16, hpc_replicas=2,\n"
        "    cloud_replicas=2, device='cpu')\n"
        "doc['models']['occam']['config']['device'] = 'cpu'\n"
        "cfg = core.load_streamflow_file(doc)\n"
        "entry = cfg.workflows['single-cell-scatter']\n"
        "ex = core.StreamFlowExecutor.from_config(\n"
        "    cfg, fault=core.FaultConfig(speculative=False))\n"
        "res = ex.run(entry.workflow, entry.bindings, inputs={'seed': 0})\n"
        "s = res.outputs['summary']\n"
        "assert s['n_samples'] == 3 and int(s['type_counts'].sum()) == 12\n"
        "assert {e.status for e in res.events} == {'completed'}\n"
        "svc = core.WorkflowService(cfg, fault=core.FaultConfig(\n"
        "    speculative=False))\n"
        "rid = svc.submit_document(doc, inputs={'seed': 0}, tenant='lab_a')\n"
        "assert svc.wait(rid, timeout=120).state == core.COMPLETE\n"
        "got = svc.result(rid).outputs['summary']\n"
        "assert (got['type_counts'] == s['type_counts']).all()\n"
        "svc.close(timeout=60)\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                      'yaml'))\n"
        "assert not bad, bad\n"
        "print('events', len(res.events))\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    # mkfastq, 3 x (count, seurat, singler), aggregate
    assert res.stdout.split()[-1] == "11"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":              # a directory with the script only
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = _env(CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH")
    res = subprocess.run([sys.executable, str(script)], env=env,
                         cwd=script.parent, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
