"""A small deterministic diamond workflow for crash-recovery drills.

The JAX package's drill workflow on the port's engine objects, used by
the port's recovery and service tests and the
``examples/resume_after_crash_torch.py`` walkthrough: every step is pure numpy
(fast, byte-for-byte reproducible), the DAG has real fan-out/fan-in so a
mid-run crash leaves a meaningful frontier, and the matching StreamFlow
document binds it to *external* sites — the user-managed deployments that
outlive a dead driver, which is what ``Executor.resume`` re-attaches to.

    /source                  -> block0..block{n-1}
    /stages/<i>/transform    -> hash-chained block digest (heavy-ish)
    /reduce                  -> single combined digest
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.workflow import Requirements, Step, Workflow


def _source_fn(n_blocks: int, block_rows: int):
    def fn(inputs: Dict, ctx) -> Dict:
        rng = np.random.default_rng(int(inputs["seed"]))
        return {f"block{i}": rng.integers(
            0, 1 << 16, size=(block_rows, 64)).astype(np.int64)
            for i in range(n_blocks)}
    return fn


def _transform_fn(i: int, rounds: int):
    def fn(inputs: Dict, ctx) -> Dict:
        x = inputs["block"].copy()
        for r in range(rounds):          # deterministic mixing rounds
            x = (x * 6364136223846793005 + 1442695040888963407 + i + r)
            x ^= x >> 17
        return {f"digest{i}": x.sum(axis=1)}
    return fn


def _reduce_fn(n_blocks: int):
    def fn(inputs: Dict, ctx) -> Dict:
        acc = np.zeros_like(inputs["d0"])
        for k in range(n_blocks):
            acc = acc * 31 + inputs[f"d{k}"]
        return {"combined": acc}
    return fn


def build_workflow(n_blocks: int = 4, block_rows: int = 256,
                   rounds: int = 50) -> Workflow:
    wf = Workflow("recovery-demo")
    wf.add_step(Step(
        path="/source", fn=_source_fn(n_blocks, block_rows),
        inputs={"seed": "seed"},
        outputs=tuple(f"block{i}" for i in range(n_blocks)),
        requirements=Requirements(cores=1, memory_gb=1)))
    for i in range(n_blocks):
        wf.add_step(Step(
            path=f"/stages/{i}/transform", fn=_transform_fn(i, rounds),
            inputs={"block": f"block{i}"}, outputs=(f"digest{i}",),
            requirements=Requirements(cores=1, memory_gb=1)))
    wf.add_step(Step(
        path="/reduce", fn=_reduce_fn(n_blocks),
        inputs={f"d{k}": f"digest{k}" for k in range(n_blocks)},
        outputs=("combined",),
        requirements=Requirements(cores=1, memory_gb=1)))
    wf.validate()
    return wf


def site_configs(replicas: int = 2) -> Dict[str, dict]:
    """Connector configs for the two user-managed sites the demo binds to
    (start them with ``start_external_site`` before running)."""
    return {
        "hpc_site": {"services": {"compute": {"replicas": replicas,
                                              "cores": 2, "memory_gb": 8}}},
        "cloud_site": {"services": {"reduce": {"replicas": 1,
                                               "cores": 1, "memory_gb": 4}}},
    }


def streamflow_doc(journal_path: str = ".streamflow/recovery-demo.jsonl",
                   n_blocks: int = 4, block_rows: int = 256,
                   rounds: int = 50, replicas: int = 2) -> dict:
    sites = site_configs(replicas)
    return {
        "version": "v1.0",
        "models": {
            "hpc_site": {"type": "local", "config": sites["hpc_site"],
                         "external": True},
            "cloud_site": {"type": "local", "config": sites["cloud_site"],
                           "external": True},
        },
        "workflows": {
            "recovery-demo": {
                "type": "python",
                "config": {"module": "repro_torch.configs.recovery_demo",
                           "builder": "build_workflow",
                           "args": {"n_blocks": n_blocks,
                                    "block_rows": block_rows,
                                    "rounds": rounds}},
                "bindings": [
                    {"step": "/",
                     "target": {"model": "hpc_site", "service": "compute"}},
                    {"step": "/reduce",
                     "target": {"model": "cloud_site", "service": "reduce"}},
                ],
            }
        },
        "scheduling": {"policy": "data_locality"},
        "checkpoint": {"journal_path": journal_path},
    }
