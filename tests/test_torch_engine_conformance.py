"""The StreamFlow-file conformance corpus (``tests/conformance/``, read
and left as it is) through both loaders: the JAX package's engine
(``repro.core``) and the port's (``repro_torch.core``).

Every valid case loads in both to the same models, tools, bindings,
policy, topology, cache, checkpoint, fault, service, autoscale and
analyze config, and to the same dry-run plan of every workflow; every
invalid case that the load-time checker catches raises
``WorkflowCheckError`` in both with the same diagnostics, in order; and
with ``check: off`` every invalid case fails (or loads) the same way in
both.

The corpus' seven analysis cases (``expect.analysis: true``) load clean in
both and fail only under the plan-time analyzer: the port's
``repro_torch.core.analyzer`` proves the same diagnostics as the JAX
package's, in order, with the case's expected codes and locations.
"""
import copy
import glob
import os

import pytest
import yaml

import repro.core as J
import repro_torch.core as T
from test_torch_engine import config_view, port_doc

CORPUS = os.path.join(os.path.dirname(__file__), "conformance")
VALID = sorted(glob.glob(os.path.join(CORPUS, "valid", "*.yaml")))
INVALID = sorted(glob.glob(os.path.join(CORPUS, "invalid", "*.yaml")))


def _case(path):
    with open(path) as f:
        case = yaml.safe_load(f)
    return case["doc"], case["expect"]


CHECKER_INVALID = [p for p in INVALID
                   if not _case(p)[1].get("analysis")]
ANALYSIS_INVALID = [p for p in INVALID if _case(p)[1].get("analysis")]


def _ids(paths):
    return [os.path.basename(p)[:-len(".yaml")] for p in paths]


def _both(doc, **kw):
    """The JAX loader on ``doc`` and the port's on its port twin (a python
    workflow's builder module named as the port's), each on its own copy."""
    return (J.load_streamflow_file(copy.deepcopy(doc), **kw),
            T.load_streamflow_file(port_doc(doc), **kw))


def test_the_corpus_was_found():
    assert (len(VALID), len(CHECKER_INVALID), len(ANALYSIS_INVALID),
            len(INVALID)) == (27, 35, 7, 42)


@pytest.mark.parametrize("path", VALID, ids=_ids(VALID))
def test_valid_case_loads_and_plans_the_same(path):
    doc, expect = _case(path)
    jcfg, tcfg = _both(doc)
    assert config_view(tcfg, T.dry_run) == \
        config_view(jcfg, J.dry_run)
    assert sorted(tcfg.workflows) == sorted(jcfg.workflows)
    if not expect.get("loads_only"):
        for entry in tcfg.workflows.values():
            entry.workflow.expand()


def _diagnostics(err):
    return [(d.code, d.location, d.message) for d in err.diagnostics]


@pytest.mark.parametrize("path", CHECKER_INVALID, ids=_ids(CHECKER_INVALID))
def test_invalid_case_raises_the_same_diagnostics(path):
    doc, expect = _case(path)
    with pytest.raises(J.WorkflowCheckError) as want:
        J.load_streamflow_file(copy.deepcopy(doc))
    with pytest.raises(T.WorkflowCheckError) as got:
        T.load_streamflow_file(port_doc(doc))
    assert _diagnostics(got.value) == _diagnostics(want.value)
    assert sorted({d.code for d in got.value.diagnostics}) == \
        sorted(expect["codes"])
    assert all(d.code in T.CHECKER_CODES for d in got.value.diagnostics)


def _outcome(core, doc):
    try:
        core.load_streamflow_file(doc, check=False)
    except (core.StreamFlowFileError, ValueError, KeyError, TypeError) as e:
        return type(e).__name__, str(e)
    return "loads", ""


@pytest.mark.parametrize("path", INVALID, ids=_ids(INVALID))
def test_invalid_case_with_check_off_fails_the_same(path):
    doc, _ = _case(path)
    assert _outcome(T, port_doc(doc)) == _outcome(J, copy.deepcopy(doc))


@pytest.mark.parametrize("path", ANALYSIS_INVALID, ids=_ids(ANALYSIS_INVALID))
def test_analysis_case_raises_the_same_diagnostics(path):
    doc, expect = _case(path)
    jcfg, tcfg = _both(doc)                  # both load clean
    want = J.analyzer.analyze(jcfg)
    got = T.analyzer.analyze(tcfg)
    assert _diagnostics(got) == _diagnostics(want)
    assert sorted({d.code for d in got.diagnostics}) == \
        sorted(expect["codes"])
    for code, substring in (expect.get("locations") or {}).items():
        assert any(substring in d.location for d in got.diagnostics
                   if d.code == code), (code, substring)
    assert all(d.code in T.analyzer.CODES and d.location and d.message
               for d in got.diagnostics)
