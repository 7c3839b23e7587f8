"""The crash-recovery drills of ``tests/test_recovery.py`` on the port's
engine and ``repro_torch.configs.recovery_demo``, on the CPU: kill the
driver between ticks, resume from the execution journal, and check the
frontier (completed steps never run again, the outputs byte-identical),
dead sites forcing re-runs, torn journal tails, and idempotent resumes.
The port's drill workflow gives the JAX package's outputs bit for bit for
the same seed, so the resumed runs are also held to the JAX package's
clean run."""

import pytest

import repro.core as J
from repro.configs import recovery_demo as jax_demo
from repro_torch.configs import recovery_demo
from repro_torch.core import (Binding, ExecutionJournal, FaultConfig,
                              JournalError, ModelSpec, StreamFlowExecutor,
                              load_streamflow_file, serialize,
                              start_external_site, stop_external_site)

WF_ARGS = dict(n_blocks=3, block_rows=32, rounds=5)


class _Crash(BaseException):
    """Raised from the tick hook: the driver dies between two ticks."""


@pytest.fixture
def external_sites():
    for name, cfg in recovery_demo.site_configs().items():
        start_external_site(name, "local", cfg)
    yield
    stop_external_site()


def _crash_hook(after_completed: int):
    def hook(tick, completed):
        if len(completed) >= after_completed:
            raise _Crash(f"driver killed with {sorted(completed)} done")
    return hook


def _run_to_crash(journal_path, after_completed=2, **executor_kw):
    cfg = load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(journal_path),
                                     **WF_ARGS))
    ex = StreamFlowExecutor.from_config(
        cfg, fault=FaultConfig(speculative=False), **executor_kw)
    ex.tick_hook = _crash_hook(after_completed)
    entry = cfg.workflows["recovery-demo"]
    with pytest.raises(_Crash):
        ex.run(entry.workflow, entry.bindings, inputs={"seed": 7})
    return cfg


def _reference_outputs(seed=7):
    """The JAX package's clean-run outputs on a throwaway internal site
    (the workflow is deterministic, so placement cannot change the
    bytes)."""
    ex = J.StreamFlowExecutor(
        {"solo": J.ModelSpec("solo", "local",
                             {"services": {"s": {"replicas": 4}}})},
        fault=J.FaultConfig(speculative=False))
    wf = jax_demo.build_workflow(**WF_ARGS)
    res = ex.run(wf, [J.Binding("/", "solo", "s")], inputs={"seed": seed})
    return res.outputs


@pytest.mark.parametrize("seed", [0, 7, 8])
def test_drill_outputs_are_the_jax_packages_bit_for_bit(seed):
    ex = StreamFlowExecutor(
        {"solo": ModelSpec("solo", "local",
                           {"services": {"s": {"replicas": 4}}})},
        fault=FaultConfig(speculative=False))
    res = ex.run(recovery_demo.build_workflow(**WF_ARGS),
                 [Binding("/", "solo", "s")], inputs={"seed": seed})
    want = _reference_outputs(seed)
    assert sorted(res.outputs) == sorted(want) == ["combined"]
    got, ref = res.outputs["combined"], want["combined"]
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    assert serialize(res.outputs) == serialize(want)


def test_drill_document_is_the_jax_packages_naming_the_ports_module():
    want = jax_demo.streamflow_doc(journal_path="j.jsonl", **WF_ARGS)
    want["workflows"]["recovery-demo"]["config"]["module"] = \
        recovery_demo.__name__
    assert recovery_demo.streamflow_doc(journal_path="j.jsonl",
                                        **WF_ARGS) == want
    assert recovery_demo.site_configs(3) == jax_demo.site_configs(3)


def test_crash_then_resume_skips_completed_and_is_byte_identical(
        tmp_path, external_sites):
    jp = tmp_path / "journal.jsonl"
    _run_to_crash(jp, after_completed=2)
    journaled = ExecutionJournal.replay(str(jp)).completed_steps
    assert len(journaled) >= 2          # the crash landed after real work

    # a brand-new driver: only the journal path survives the crash
    ex2 = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False))
    res = ex2.resume()                  # workflow+bindings rebuilt from WAL

    rerun = {e.step for e in res.events if e.status == "completed"}
    assert not rerun & journaled        # zero re-executions of journaled work
    assert rerun == set(
        recovery_demo.build_workflow(**WF_ARGS).steps) - journaled
    assert serialize(res.outputs) == serialize(_reference_outputs())


def test_resume_with_dead_site_reruns_lost_steps(tmp_path):
    # internal (non-external) models: the sites die with the driver, so the
    # journaled token locations must FAIL Connector verification on resume
    jp = tmp_path / "journal.jsonl"
    wf = recovery_demo.build_workflow(**WF_ARGS)
    models = {"pool": ModelSpec("pool", "local",
                                {"services": {"s": {"replicas": 4}}})}
    bindings = [Binding("/", "pool", "s")]
    ex = StreamFlowExecutor(models, checkpoint=str(jp),
                            fault=FaultConfig(speculative=False))
    ex.tick_hook = _crash_hook(2)
    with pytest.raises(_Crash):
        ex.run(wf, bindings, inputs={"seed": 7})
    journaled = ExecutionJournal.replay(str(jp)).completed_steps
    assert journaled

    ex2 = StreamFlowExecutor(models, fault=FaultConfig(speculative=False))
    res = ex2.resume(str(jp), workflow=recovery_demo.build_workflow(**WF_ARGS),
                     bindings=bindings)
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert journaled <= rerun           # dead site => journal not trusted
    assert serialize(res.outputs) == serialize(_reference_outputs())


def test_payload_journal_survives_total_site_loss(tmp_path):
    # with include_payloads the WAL itself carries the completed outputs,
    # so even internal-site death cannot force a re-run
    jp = tmp_path / "journal.jsonl"
    wf = recovery_demo.build_workflow(**WF_ARGS)
    models = {"pool": ModelSpec("pool", "local",
                                {"services": {"s": {"replicas": 4}}})}
    bindings = [Binding("/", "pool", "s")]
    ex = StreamFlowExecutor(
        models, fault=FaultConfig(speculative=False),
        checkpoint={"journal_path": str(jp), "include_payloads": True})
    ex.tick_hook = _crash_hook(2)
    with pytest.raises(_Crash):
        ex.run(wf, bindings, inputs={"seed": 7})
    journaled = ExecutionJournal.replay(str(jp)).completed_steps

    ex2 = StreamFlowExecutor(models, fault=FaultConfig(speculative=False))
    res = ex2.resume(str(jp), workflow=recovery_demo.build_workflow(**WF_ARGS),
                     bindings=bindings)
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert not rerun & journaled
    assert serialize(res.outputs) == serialize(_reference_outputs())


def test_resume_tolerates_truncated_journal_tail(tmp_path, external_sites):
    jp = tmp_path / "journal.jsonl"
    _run_to_crash(jp, after_completed=2)
    with open(jp, "a", encoding="utf-8") as fh:
        fh.write('{"v":1,"kind":"step","path":"/redu')   # the torn record
    journaled = ExecutionJournal.replay(str(jp)).completed_steps

    ex2 = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False))
    res = ex2.resume()
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert not rerun & journaled
    assert serialize(res.outputs) == serialize(_reference_outputs())


def test_second_crash_after_torn_tail_resume_still_recovers(
        tmp_path, external_sites):
    # crash -> torn tail -> resume -> crash again -> resume: the resumed
    # run's records must not have merged into the torn line
    jp = tmp_path / "journal.jsonl"
    _run_to_crash(jp, after_completed=1)
    with open(jp, "a", encoding="utf-8") as fh:
        fh.write('{"v":1,"kind":"step","path":"/st')
    cfg = load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS))
    ex = StreamFlowExecutor.from_config(cfg,
                                        fault=FaultConfig(speculative=False))
    ex.tick_hook = _crash_hook(3)
    with pytest.raises(_Crash):
        ex.resume()
    journaled = ExecutionJournal.replay(str(jp)).completed_steps
    assert len(journaled) >= 3

    res = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False)).resume()
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert not rerun & journaled
    assert serialize(res.outputs) == serialize(_reference_outputs())


def test_double_resume_is_idempotent(tmp_path, external_sites):
    jp = tmp_path / "journal.jsonl"
    _run_to_crash(jp, after_completed=1)
    first = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False)).resume()

    again = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False)).resume()
    assert [e for e in again.events if e.status == "completed"] == []
    assert serialize(again.outputs) == serialize(first.outputs)


def test_crash_resume_in_serialized_mode(tmp_path, external_sites):
    # the journal is mode-agnostic: the paper's serialized FCFS loop writes
    # and resumes the same WAL
    jp = tmp_path / "journal.jsonl"
    _run_to_crash(jp, after_completed=1, pipelined=False)
    journaled = ExecutionJournal.replay(str(jp)).completed_steps
    ex2 = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False), pipelined=False)
    res = ex2.resume()
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert not rerun & journaled
    assert serialize(res.outputs) == serialize(_reference_outputs())


def test_resume_without_builder_info_needs_explicit_workflow(tmp_path):
    jp = tmp_path / "journal.jsonl"
    wf = recovery_demo.build_workflow(**WF_ARGS)      # hand-built: no builder
    models = {"pool": ModelSpec("pool", "local",
                                {"services": {"s": {"replicas": 2}}})}
    ex = StreamFlowExecutor(models, checkpoint=str(jp),
                            fault=FaultConfig(speculative=False))
    ex.tick_hook = _crash_hook(1)
    with pytest.raises(_Crash):
        ex.run(wf, [Binding("/", "pool", "s")], inputs={"seed": 7})
    ex2 = StreamFlowExecutor(models, fault=FaultConfig(speculative=False))
    with pytest.raises(JournalError):
        ex2.resume(str(jp))             # journal cannot rebuild the DAG

    res = ex2.resume(str(jp), workflow=recovery_demo.build_workflow(**WF_ARGS),
                     bindings=[Binding("/", "pool", "s")])
    assert serialize(res.outputs) == serialize(_reference_outputs())


def test_resume_appends_to_the_replayed_journal(tmp_path, external_sites):
    # an executor configured with journal A that resumes journal B must
    # write the resumed run's records into B — otherwise a second crash
    # would resume B from stale state
    jp = tmp_path / "crashed.jsonl"
    _run_to_crash(jp, after_completed=1)
    other = tmp_path / "other.jsonl"
    ex2 = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(other), **WF_ARGS)),
        fault=FaultConfig(speculative=False))
    res = ex2.resume(str(jp))
    assert res.outputs
    assert ex2.journal.path == str(jp)
    after = ExecutionJournal.replay(str(jp))
    assert after.run_ended
    assert after.completed_steps == set(
        recovery_demo.build_workflow(**WF_ARGS).steps)


def test_resume_does_not_regrow_input_payloads(tmp_path, external_sites):
    jp = tmp_path / "journal.jsonl"
    _run_to_crash(jp, after_completed=1)

    def n_input_records():
        with open(jp, encoding="utf-8") as fh:
            return sum(1 for line in fh if '"kind":"input"' in line)

    before = n_input_records()
    StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False)).resume()
    assert n_input_records() == before  # inputs are already durable
    # an overriding value must be journaled AND must invalidate every
    # journaled-complete step downstream of it — otherwise the outputs
    # would silently mix the two input epochs
    res = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False)).resume(inputs={"seed": 8})
    assert n_input_records() == before + 1
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert rerun == set(recovery_demo.build_workflow(**WF_ARGS).steps)
    assert serialize(res.outputs) == serialize(_reference_outputs(seed=8))


def test_resume_rejects_mismatched_workflow(tmp_path, external_sites):
    jp = tmp_path / "journal.jsonl"
    _run_to_crash(jp, after_completed=1)
    other = recovery_demo.build_workflow(n_blocks=2, block_rows=32, rounds=5)
    ex2 = StreamFlowExecutor.from_config(load_streamflow_file(
        recovery_demo.streamflow_doc(journal_path=str(jp), **WF_ARGS)),
        fault=FaultConfig(speculative=False))
    with pytest.raises(JournalError):
        ex2.resume(workflow=other)
