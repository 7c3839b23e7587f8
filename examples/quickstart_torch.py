"""Quickstart on the port: the paper's single-cell workflow on a hybrid
HPC+cloud environment defined by a StreamFlow file, run by the PyTorch
port's engine (the twin of ``quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

What happens: one splitter fans a synthetic corpus out to 3 chains; the
heavy 'count' steps (training a tiny LM: the flash kernel's forward and
backward) run on the 'occam' mesh site; the 'seurat'/'singler' analysis
steps run on the 'garr_cloud' local site.  The two sites share NO data
space: the DataManager moves the intermediate models across with the
two-step copy (R3) and elides anything already in place (R4).  The count
and seurat steps compute on the GPU unless ``--device`` names another
device, which also goes into the mesh site's config.  Reading the YAML
file needs PyYAML.  The run's journal goes to
``.streamflow/singlecell_hybrid_torch.jsonl`` under the working directory.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import yaml  # noqa: E402

from repro_torch.core import (StreamFlowExecutor,  # noqa: E402
                              load_streamflow_file)

HERE = os.path.dirname(os.path.abspath(__file__))
DOC = os.path.join(HERE, "singlecell_hybrid_torch.yaml")


def load_doc(device=None) -> dict:
    """The YAML twin as a dict; ``device`` (None: the GPU) goes into the
    mesh site's config and every workflow builder's args."""
    with open(DOC) as f:
        doc = yaml.safe_load(f)
    if device is not None:
        doc["models"]["occam"]["config"]["device"] = device
        for w in doc["workflows"].values():
            w["config"]["args"]["device"] = device
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the count and seurat steps and "
                         "of the mesh site (default: the GPU)")
    args = ap.parse_args(argv)
    cfg = load_streamflow_file(load_doc(args.device))
    executor = StreamFlowExecutor.from_config(cfg)
    entry = cfg.workflows["single-cell"]
    result = executor.run(entry.workflow, entry.bindings,
                          inputs={"seed": 0})

    print(f"\nfinished in {result.wall_seconds:.1f}s; outputs:")
    for token in sorted(result.outputs):
        v = result.outputs[token]
        desc = (f"losses={['%.3f' % x for x in v['losses']]}"
                if token.startswith("stats")
                else f"cluster_types={v['cluster_types'].tolist()}")
        print(f"  {token}: {desc}")

    print("\ntransfer accounting (R3 two-step vs R4 elided):")
    summary = executor.data.transfer_summary()
    for kind, s in summary.items():
        print(f"  {kind:<12s} n={int(s['n']):3d}  bytes={int(s['bytes']):>10,}")

    print("\nexecution timeline:")
    for row in result.timeline_rows():
        step, resource, t0, t1, status, attempt, spec = row
        print(f"  {step:<22s} on {resource:<22s} "
              f"[{t0:7.2f}s – {t1:7.2f}s] {status}")
    return result, summary


if __name__ == "__main__":
    main()
