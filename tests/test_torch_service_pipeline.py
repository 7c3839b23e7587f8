"""The CPU rehearsals of ``chip_smoke.py``'s phases 39 (``pipeline
service``) and 40 (``pipeline recovery``): the port's §5 documents with
``device: cpu`` in the mesh site and the computing tools, at a small size.

Several tenants' runs share one service and one pool of sites and give
a lone run's results; a run cancelled partway resumes from its journal
to the same results, re-running no journaled invocation; the analyzer's
makespan lower bound from a run's least invocation seconds does not
exceed the run's span; and the python-builder document, its driver
killed between ticks, resumes from the journal path alone.  The cancel
is made deterministic by a gate that holds the later count invocations
until the cancel has been sent, never by a sleep.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch import pipeline
from repro_torch.core import (CANCELED, COMPLETE, ExecutionJournal,
                              FaultConfig, StreamFlowExecutor,
                              WorkflowService, load_streamflow_file)
from repro_torch.core.analyzer import analyze

# 16 slots: more than the two runs' 12 counts, so that the gated counts
# of the cancel test never hold every slot the ungated ones need
SIZE = dict(n_samples=6, rows_per_sample=4, seq_len=16, train_steps=1,
            batch=2, vocab=64, d_model=16, hpc_replicas=8, cloud_replicas=8)
SERVICE = {"max_concurrent": 2,
           "pool": {"enabled": True, "keepalive_s": None},
           "tenants": {"lab_a": {"share": 1.0}, "lab_b": {"share": 1.0}}}
WAIT_S = 120


def hybrid(**extra):
    doc = pipeline.streamflow_doc_declarative_hybrid(**SIZE, device="cpu")
    doc["models"]["occam"]["config"]["device"] = "cpu"
    doc.update(extra)
    return doc


def run_alone(doc, seed):
    cfg = load_streamflow_file(doc)
    entry = next(iter(cfg.workflows.values()))
    return StreamFlowExecutor.from_config(
        cfg, fault=FaultConfig(speculative=False)).run(
        entry.workflow, entry.bindings, inputs={"seed": seed})


def assert_same_result(got, want):
    g, w = got["summary"], want["summary"]
    assert g["n_samples"] == w["n_samples"]
    assert np.array_equal(g["type_counts"], w["type_counts"])
    assert g["mean_confidence"] == pytest.approx(w["mean_confidence"],
                                                 rel=1e-6)
    assert [v for s in got["stats"] for v in s["losses"]] == pytest.approx(
        [v for s in want["stats"] for v in s["losses"]], rel=1e-6)


@pytest.fixture(scope="module")
def alone():
    """A lone run's outputs from seeds 0 and 1."""
    return {seed: run_alone(hybrid(), seed).outputs for seed in (0, 1)}


def test_tenants_share_one_pool_and_get_a_lone_runs_results(alone):
    svc = WorkflowService(load_streamflow_file(hybrid(service=SERVICE)),
                          fault=FaultConfig(speculative=False))
    try:
        runs = [(svc.submit_document(
            hybrid(**({"analyze": {"fail_on": "error"}}
                      if tenant == "lab_b" else {})),
            inputs={"seed": seed}, tenant=tenant), seed)
            for seed in (0, 1) for tenant in ("lab_a", "lab_b")]
        for rid, seed in runs:
            assert svc.wait(rid, timeout=WAIT_S).state == COMPLETE
            assert_same_result(svc.result(rid).outputs, alone[seed])
        assert svc.pool.deploy_count == 2
        tenants = [svc.status(rid).tenant for rid, _ in runs]
        assert tenants == ["lab_a", "lab_b"] * 2
    finally:
        svc.close(timeout=WAIT_S)
    assert not svc.pool.manager.deployments_map


def test_a_cancelled_run_resumes_to_a_lone_runs_results(alone, tmp_path,
                                                       monkeypatch):
    """Counts of sample 2 and later wait at a gate until the cancel is
    sent, so the run cannot end first; the resume by a new executor
    re-runs only what the journal does not hold as completed."""
    gate = threading.Event()
    real = pipeline.count_tool

    def gated_count_tool(*args, **kwargs):
        body = real(*args, **kwargs)

        def fn(inputs, ctx):
            if ctx.get("tag", (0,))[0] >= 2:
                assert gate.wait(timeout=WAIT_S)
            return body(inputs, ctx)
        return fn
    monkeypatch.setattr(pipeline, "count_tool", gated_count_tool)

    journal = str(tmp_path / "cancel.jsonl")
    svc = WorkflowService(load_streamflow_file(hybrid(service=SERVICE)),
                          fault=FaultConfig(speculative=False),
                          deadlock_timeout_s=0.5)
    try:
        rid = svc.submit_document(
            hybrid(), inputs={"seed": 0}, tenant="lab_a",
            checkpoint={"journal_path": journal, "include_payloads": True})
        other = svc.submit_document(hybrid(), inputs={"seed": 1},
                                    tenant="lab_b")
        # mkfastq and the two ungated counts, polled with a deadline
        done, deadline = set(), time.monotonic() + WAIT_S
        while len(done) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
            done = ExecutionJournal.replay(journal).completed_steps
        assert len(done) >= 3
        svc.cancel(rid)
        gate.set()
        assert svc.wait(rid, timeout=60).state == CANCELED
        assert svc.wait(other, timeout=WAIT_S).state == COMPLETE
        assert_same_result(svc.result(other).outputs, alone[1])
    finally:
        gate.set()
        svc.close(timeout=WAIT_S)

    state = ExecutionJournal.replay(journal)
    assert state.cancelled
    journaled = set(state.completed_steps)
    cfg = load_streamflow_file(hybrid())
    entry = cfg.workflows["single-cell-scatter"]
    res = StreamFlowExecutor.from_config(
        cfg, fault=FaultConfig(speculative=False)).resume(
        journal, entry.workflow, entry.bindings)
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert rerun and not rerun & journaled
    assert rerun | journaled == set(entry.workflow.expand().steps)
    assert_same_result(res.outputs, alone[0])


def test_the_analyzers_bound_does_not_exceed_a_runs_span():
    doc = hybrid()
    res = run_alone(doc, 0)
    least = {}
    for e in res.events:
        step = e.step.split("@")[0]
        least[step] = min(least.get(step, float("inf")), e.end - e.start)
    span = max(e.end for e in res.events) - min(e.start for e in res.events)
    report = analyze(load_streamflow_file(doc), step_costs=least,
                     default_cost_s=0.0)
    assert not report.errors()
    cost = report.cost["single-cell-scatter"]
    assert 0 < cost["makespan_lower_bound_s"] <= span
    assert cost["n_invocations"] == 3 * SIZE["n_samples"] + 2


class DriverKilled(BaseException):
    pass


def test_a_killed_driver_resumes_from_the_journal_alone(alone, tmp_path):
    """The python-builder document (``streamflow_doc_scatter_hybrid``,
    plan-identical to the declarative one), journaled with its payloads;
    the driver dies once 12 invocations have completed."""
    journal = str(tmp_path / "recovery.jsonl")
    doc = pipeline.streamflow_doc_scatter_hybrid(**SIZE, device="cpu")
    doc["models"]["occam"]["config"]["device"] = "cpu"
    doc["checkpoint"] = {"journal_path": journal, "include_payloads": True}
    cfg = load_streamflow_file(doc)
    entry = cfg.workflows["single-cell"]
    ex = StreamFlowExecutor.from_config(cfg,
                                        fault=FaultConfig(speculative=False))

    def crash(tick, completed):
        if len(completed) >= 12:
            raise DriverKilled(sorted(completed))
    ex.tick_hook = crash
    with pytest.raises(DriverKilled):
        ex.run(entry.workflow, entry.bindings, inputs={"seed": 0})
    journaled = set(ExecutionJournal.replay(journal).completed_steps)
    assert len(journaled) >= 12

    res = StreamFlowExecutor.from_config(
        load_streamflow_file(doc),
        fault=FaultConfig(speculative=False)).resume(journal)
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert rerun and not rerun & journaled
    assert rerun | journaled == set(entry.workflow.expand().steps)
    assert_same_result(res.outputs, alone[0])
