"""The port's StreamFlow command line (``python -m repro_torch.cli check |
analyze <file> [--plan] [--json]``) against the JAX package's
(``python -m repro.cli``), on the CPU.

Every conformance case (written out as a StreamFlow file, its python
workflows naming the port's builders on the port's side) and every
example YAML, through each command and output mode: the same lines, the
same JSON and the same exit code in both, the file's path and the builder
module's name aside.  A few runs go through ``python -m`` in a process of
their own, to hold the entry point itself.
"""
import contextlib
import io
import os
import subprocess
import sys

import pytest
import yaml

from repro import cli as jcli
from repro_torch import cli as tcli
from repro_torch.core import analyzer
from test_torch_engine import port_doc
from test_torch_engine_conformance import INVALID, VALID, _case, _ids

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [("check",), ("check", "--json"), ("check", "--plan"),
         ("analyze",), ("analyze", "--json")]
EXAMPLES = [("singlecell_hybrid.yaml", "singlecell_hybrid_torch.yaml"),
            ("singlecell_declarative.yaml",
             "singlecell_declarative_torch.yaml")]


def _call(main, argv):
    """(exit code, stdout) of a CLI ``main`` called in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def _same(jpath, tpath, modes=MODES):
    for mode in modes:
        want = _call(jcli.main, [*mode[:1], jpath, *mode[1:]])
        got = _call(tcli.main, [*mode[:1], tpath, *mode[1:]])
        norm = got[1].replace(tpath, jpath).replace(
            "repro_torch.pipeline", "repro.configs.paper_pipeline")
        assert (got[0], norm) == want, mode


def _write(path, doc):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    return str(path)


CASES = VALID + INVALID


@pytest.mark.parametrize("path", CASES, ids=_ids(CASES))
def test_corpus_case_gives_the_same_output(path, tmp_path):
    doc, expect = _case(path)
    name = os.path.basename(path)
    jpath = _write(tmp_path / "jax" / name, doc)
    tpath = _write(tmp_path / "port" / name, port_doc(doc))
    _same(jpath, tpath)
    # analyze fails on errors only: the checker's (forced on, also where
    # the document says ``check: off``), or an analysis case's SF3xx codes
    # of error severity
    rc, _ = _call(tcli.main, ["analyze", tpath])
    warnings_only = expect.get("analysis") and all(
        analyzer.SEVERITY[code] == "warning" for code in expect["codes"])
    checked_off = doc.get("check") in (False, "off")
    assert rc == int(checked_off or (path in INVALID and not warnings_only))


@pytest.mark.parametrize("jax_name,port_name", EXAMPLES,
                         ids=[p for _, p in EXAMPLES])
def test_example_yaml_twin_gives_the_same_output(jax_name, port_name):
    _same(os.path.join(ROOT, "examples", jax_name),
          os.path.join(ROOT, "examples", port_name))
    rc, out = _call(tcli.main, ["analyze", os.path.join(
        ROOT, "examples", port_name)])
    assert rc == 0 and out.splitlines()[-1].startswith("OK: ")


def test_a_missing_file_fails_the_same(tmp_path):
    missing = str(tmp_path / "nope.yaml")
    _same(missing, missing)
    assert _call(tcli.main, ["check", missing])[0] == 1


def _modules(*runs):
    """(exit code, stdout) of each ``python -m <module> <argv>`` in
    ``runs``, the processes started together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-m", name, *argv], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True)
             for name, argv in runs]
    return [(p.returncode, out) for p, out in
            ((p, p.communicate(timeout=120)[0]) for p in procs)]


@pytest.mark.parametrize("argv", [
    ("check", "examples/singlecell_hybrid{}.yaml"),
    ("analyze", "--json", "examples/singlecell_declarative{}.yaml"),
    ("analyze", "{tmp}/i36.yaml"),
], ids=["check", "analyze-json", "analyze-wedge"])
def test_python_dash_m_gives_the_same_output(argv, tmp_path):
    wedge = _case(os.path.join(ROOT, "tests", "conformance", "invalid",
                               "i36_sf300_gather_wedge.yaml"))[0]
    _write(tmp_path / "i36.yaml", wedge)
    jargs = [a.format("", tmp=tmp_path) for a in argv]
    targs = [a.format("_torch", tmp=tmp_path) for a in argv]
    want, got = _modules(("repro.cli", jargs), ("repro_torch.cli", targs))
    assert got[0] == want[0] == (1 if argv[-1].startswith("{tmp}") else 0)
    assert got[1].replace(targs[-1], jargs[-1]) == want[1]


def test_the_cli_refuses_an_unknown_command():
    with pytest.raises(SystemExit) as e:
        _call(tcli.main, ["frobnicate", "x.yaml"])
    assert e.value.code == 2
