"""Crash-recovery walkthrough on the port: kill the driver mid-workflow,
then resume (the twin of ``resume_after_crash.py``).

    PYTHONPATH=src python examples/resume_after_crash_torch.py
    PYTHONPATH=src python examples/resume_after_crash_torch.py --device cpu

Two drills, each on a write-ahead execution journal that a tick hook cuts
short by killing the driver, and each resumed by a brand-new executor that
is given nothing but the journal: the workflow and bindings are rebuilt
from the journaled builder reference, and only the lost frontier runs
again.

1. The recovery-demo diamond (numpy hash-chain transforms and a reduce,
   ``repro_torch.configs.recovery_demo``) on two *external* (user-managed)
   sites, which outlive the driver: each completed step's outputs are
   verified in their stores through the Connector.
2. The paper's §5 single-cell scatter workflow
   (``repro_torch.pipeline.streamflow_doc_scatter_hybrid``, cut to a few
   small samples), whose count steps train on the device (the GPU unless
   ``--device`` names another): the sites die with the driver, so the
   journal carries the completed outputs (``include_payloads``).

The journals go to ``.streamflow/`` under the working directory.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import pipeline  # noqa: E402
from repro_torch.configs import recovery_demo  # noqa: E402
from repro_torch.core import (FaultConfig, StreamFlowExecutor,  # noqa: E402
                              load_streamflow_file, start_external_site,
                              stop_external_site)

JOURNAL = ".streamflow/resume_demo_torch.jsonl"
PIPELINE_JOURNAL = ".streamflow/resume_pipeline_torch.jsonl"
PIPELINE_ARGS = dict(n_samples=4, hpc_replicas=2, cloud_replicas=2,
                     rows_per_sample=8, seq_len=32, train_steps=2, batch=4)


class DriverKilled(BaseException):
    pass


def kill_after(n_completed: int):
    def hook(tick, completed):
        if len(completed) >= n_completed:
            raise DriverKilled(f"simulated crash; done={sorted(completed)}")
    return hook


def drill(doc: dict, workflow: str, n_completed: int, seed: int = 0):
    """Run ``doc``'s workflow until the driver dies, then resume it with a
    new executor from the journal alone: (completed before the crash,
    re-run invocations, the resumed RunResult)."""
    path = doc["checkpoint"]["journal_path"]
    if os.path.exists(path):
        os.unlink(path)                    # a fresh drill each invocation
    cfg = load_streamflow_file(doc)
    ex = StreamFlowExecutor.from_config(cfg,
                                        fault=FaultConfig(speculative=False))
    ex.tick_hook = kill_after(n_completed)
    entry = cfg.workflows[workflow]
    try:
        ex.run(entry.workflow, entry.bindings, inputs={"seed": seed})
    except DriverKilled as e:
        print(f"driver died: {e}")
    done = sorted(e.step for e in ex.events if e.status == "completed")

    print(f"resuming from {path} with a brand-new executor ...")
    ex2 = StreamFlowExecutor.from_config(load_streamflow_file(doc),
                                         fault=FaultConfig(speculative=False))
    res = ex2.resume()
    rerun = sorted(e.step for e in res.events if e.status == "completed")
    print(f"re-executed only the lost frontier: {rerun}")
    return done, rerun, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the §5 drill's count and seurat "
                         "steps and of its mesh site (default: the GPU)")
    args = ap.parse_args(argv)

    print("1. the recovery-demo diamond on external sites")
    for name, site_cfg in recovery_demo.site_configs().items():
        start_external_site(name, "local", site_cfg)
    try:
        _, _, demo = drill(recovery_demo.streamflow_doc(journal_path=JOURNAL),
                           "recovery-demo", 2)
    finally:
        stop_external_site()
    print(f"combined digest head: {demo.outputs['combined'][:4]}")

    print("\n2. the §5 scatter workflow, its outputs in the journal")
    device = {} if args.device is None else {"device": args.device}
    doc = pipeline.streamflow_doc_scatter_hybrid(**PIPELINE_ARGS, **device)
    doc["models"]["occam"]["config"].update(device)
    doc["checkpoint"] = {"journal_path": PIPELINE_JOURNAL,
                         "include_payloads": True}
    _, _, res = drill(doc, "single-cell", 6)
    summary = res.outputs["summary"]
    print(f"summary: {summary['n_samples']} samples, type counts "
          f"{summary['type_counts'].tolist()}, mean confidence "
          f"{summary['mean_confidence']:.4f}")
    return demo, res


if __name__ == "__main__":
    main()
