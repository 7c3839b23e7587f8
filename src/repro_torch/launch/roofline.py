"""Roofline aggregator: the dry run's JSON records -> a markdown table
(PyTorch port of ``repro/launch/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir build/dryrun

Per (arch x shape x mesh), on one H100 or per card of a mesh of ``chips``
H100s: the three roofline terms (seconds), the dominant one, MODEL_FLOPS /
counted FLOPs (both over every card), the roofline fraction, the
arguments' and the temporaries' memory and whether they fit the card's
80 GB, and a what-would-move-the-dominant-term-down note from the cell's
mix of FLOPs, bytes and collectives.  ``--pod`` keeps the single mesh's
records (``pod1``, the default), the two pods' of ``--multi-pod``
(``pod2``), or ``both``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.mesh import HBM_BYTES


def load_records(dir_: str, suffix: str = "") -> List[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        stem = os.path.basename(path)[:-5]
        parts = stem.split("__")
        want_suffix = parts[3] if len(parts) > 3 else ""
        if want_suffix != suffix:
            continue
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def advice(rec: dict) -> str:
    r = rec.get("roofline", {})
    dom = r.get("dominant")
    coll = rec.get("counted", {}).get("collective_wire_bytes", {})
    ratio = r.get("useful_ratio", 0)
    if dom == "memory":
        if ratio < 0.2:
            return ("elementwise and attention-probability traffic dominates "
                    "— shard the sequence (context parallel) or fuse it into "
                    "a kernel that keeps it on chip")
        return "cut activation round-trips: fuse/remat or larger microbatch"
    if dom == "collective":
        big = max(coll, key=coll.get) if coll else "all-gather"
        if big == "all-gather":
            return ("weight all-gathers dominate — fewer FSDP gathers "
                    "(group layers) or keep the embedding unsharded")
        return f"{big} dominates — reshard to cut cross-card traffic"
    if ratio and ratio < 0.5:
        return ("counted FLOPs are >2x model FLOPs — drop replicated "
                "compute or remat recompute")
    return "near compute roof — tune block shapes / overlap collectives"


def footprint(rec: dict) -> int:
    """A cell's bytes on a card: its arguments plus its temporaries."""
    mem = rec.get("memory", {})
    return mem.get("argument_size_in_bytes", 0) + \
        mem.get("temp_size_in_bytes", 0)


def fits(rec: dict) -> bool:
    """Whether a counted cell's arguments and temporaries fit a card's
    80 GB."""
    return footprint(rec) <= HBM_BYTES


def fmt_row(rec: dict) -> Dict[str, str]:
    r = rec["roofline"]
    mem = rec.get("memory", {})
    arg = mem.get("argument_size_in_bytes", 0)
    temp = mem.get("temp_size_in_bytes", 0)
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": rec.get("mesh", "1xH100"),
        "chips": str(rec.get("chips", 1)),
        "compute_s": f"{r['compute_s']:.4f}",
        "memory_s": f"{r['memory_s']:.4f}",
        "collective_s": f"{r['collective_s']:.4f}",
        "dom": r["dominant"],
        "useful": f"{r['useful_ratio']:.3f}",
        "frac": f"{r['roofline_frac']:.4f}",
        "arg_GB": f"{arg / 1e9:.1f}",
        "temp_GB": f"{temp / 1e9:.1f}",
        "fits": "Y" if fits(rec) else "OVER",
    }


def markdown_table(rows: List[Dict[str, str]]) -> str:
    if not rows:
        return "(no records)"
    cols = list(rows[0])
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        out.append("| " + " | ".join(r[c] for c in cols) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--suffix", default="",
                    help="variant suffix")
    ap.add_argument("--pod", choices=["pod1", "pod2", "both"], default="pod1",
                    help="the single mesh's records, the two pods', or both")
    ap.add_argument("--advice", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    rows, skips, errors = [], [], []
    for rec in load_records(args.dir, args.suffix):
        tag = "pod2" if rec.get("multi_pod") else "pod1"
        if args.pod != "both" and tag != args.pod:
            continue
        if "skip" in rec:
            skips.append((rec["arch"], rec["shape"], rec["skip"]))
        elif "error" in rec:
            errors.append((rec["arch"], rec["shape"], rec["error"]))
        else:
            row = fmt_row(rec)
            if args.advice:
                row["next_move"] = advice(rec)
            rows.append(row)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print(markdown_table(rows))
    if skips:
        print("\nSkipped cells:")
        for a, s, why in sorted(set(skips)):
            print(f"  - {a} x {s}: {why}")
    if errors:
        print("\nERRORS:")
        for a, s, e in errors:
            print(f"  - {a} x {s}: {e}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
