#!/usr/bin/env python3
"""Derive the port's mesh-selection table (``_PREFERRED`` of
``repro_torch/distributed/meshselect.py``) from its own dry run.

    PYTHONPATH=src python3 tools/meshselect_sweep.py --jobs 4
    PYTHONPATH=src python3 tools/meshselect_sweep.py --arch minicpm-2b \\
        --kind prefill --chips 4
    PYTHONPATH=src python3 tools/meshselect_sweep.py --from-records

For each zoo arch, each kind (``train`` on train_4k, ``prefill`` on
prefill_32k, ``decode`` on decode_32k) and each number of cards (4, and 8:
a node), every candidate is counted by ``launch.dryrun.run_cell`` on fake
ranks: every power-of-two (dp, tp) with dp * tp = chips, under the
``base`` ruleset, and under ``ep`` too for a MoE config whose experts
split over tp.  A candidate fits when its arguments and temporaries fit a
card's 80 GB (``roofline.fits``).  A prefill or decode candidate runs at
accum_steps 1; a train candidate at the smallest power of two up to
global_batch // dp at which it fits.  The temporaries of a microbatch of
B / a rows are at least 1 / a of those of B rows (a part that does not
shrink with the rows only adds), so after a count at ``a`` the search goes
straight to the least accum that this bound does not rule out, and stops
where none up to global_batch // dp is left.  Skip and error records are
never candidates.

Among the candidates that fit, the least ``roofline.bound_s`` wins; a tie
goes to the smaller tp, then to ``base``.  An (arch, kind, chips) where
none fits gets no entry (``preferred_mesh`` then gives the square split),
and the sweep says why.  The records go to ``--out`` (one per count,
named ``<arch>__<shape>__<mesh>__<ruleset>_a<accum>``); the table is
printed as Python source for ``_PREFERRED`` and as a markdown table.  The
bounds are the dry run's predictions on the H100 data sheet's figures, not
measurements.  ``fake_group`` makes one process group a process, so the
candidates run in ``--jobs`` worker processes (about 350 MB each).
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import multiprocessing
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch.mesh import HBM_BYTES  # noqa: E402
from repro_torch.launch.roofline import fits, footprint  # noqa: E402
from repro_torch.models.config import SHAPES_BY_NAME  # noqa: E402

KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}
CHIPS = (4, 8)
OUT = os.path.join("build", "meshselect")

Candidate = Tuple[str, str, int, int, int, str]  # arch kind chips dp tp rules


def splits(chips: int) -> List[Tuple[int, int]]:
    """Every power-of-two (dp, tp) with dp * tp == chips, tp ascending."""
    out, tp = [], 1
    while tp <= chips:
        out.append((chips // tp, tp))
        tp *= 2
    return out


def candidates(arch: str, kind: str, chips: int) -> List[Candidate]:
    cfg = get_arch(arch)
    out = []
    for dp, tp in splits(chips):
        out.append((arch, kind, chips, dp, tp, "base"))
        if cfg.is_moe and cfg.n_experts % tp == 0:
            out.append((arch, kind, chips, dp, tp, "ep"))
    return out


def _next_accum(rec: dict, limit: int) -> Optional[int]:
    """The least power-of-two accum above the record's that its
    temporaries' bound does not rule out, or None where none up to
    ``limit`` is left."""
    mem = rec["memory"]
    args, temp = mem["argument_size_in_bytes"], mem["temp_size_in_bytes"]
    a = rec["accum_steps"]
    if args >= HBM_BYTES:
        return None
    nxt = 2 * a
    while nxt <= limit and args + temp * a / nxt > HBM_BYTES:
        nxt *= 2
    return nxt if nxt <= limit else None


def lower_candidate(cand: Candidate, out_dir: str) -> List[dict]:
    """The records of one candidate: one count, or a train candidate's
    counts up to the first that fits."""
    from repro_torch.launch.dryrun import run_cell
    arch, kind, chips, dp, tp, rules = cand
    shape = KIND_SHAPE[kind]
    limit = SHAPES_BY_NAME[shape].global_batch // dp if kind == "train" \
        else 1
    recs, accum = [], 1
    while accum is not None:
        rec = run_cell(arch, shape, out_dir, f"{rules}_a{accum}", dp=dp,
                       tp=tp, ruleset=rules, accum_steps=accum)
        recs.append(rec)
        if "skip" in rec or "error" in rec or fits(rec):
            break
        accum = _next_accum(rec, limit)
    return recs


def _counted(rec: dict) -> bool:
    return "skip" not in rec and "error" not in rec


def _key(rec: dict):
    return (rec["roofline"]["bound_s"], rec["mesh_dp_tp"][1],
            rec["ruleset"] != "base")


def choose(records: Sequence[dict]) -> Tuple[Optional[dict],
                                             Optional[dict]]:
    """(the winner, the runner-up) among the records of one (arch, kind,
    chips): each candidate (split and ruleset) by its record at the least
    accum that fits, the least ``bound_s`` first, a tie to the smaller tp,
    then to ``base``.  Records that skip, fail or do not fit are never
    chosen; (None, None) where none is left."""
    best: Dict[Tuple, dict] = {}
    for rec in records:
        if not _counted(rec) or not fits(rec):
            continue
        cand = (tuple(rec["mesh_dp_tp"]), rec["ruleset"])
        if cand not in best or \
                rec["accum_steps"] < best[cand]["accum_steps"]:
            best[cand] = rec
    ranked = sorted(best.values(), key=_key)
    return (ranked[0] if ranked else None,
            ranked[1] if len(ranked) > 1 else None)


def why_none(records: Sequence[dict]) -> str:
    """Why no record of an (arch, kind, chips) was chosen."""
    skips = sorted({r["skip"] for r in records if "skip" in r})
    errors = [r for r in records if "error" in r]
    counted = [r for r in records if _counted(r)]
    parts = []
    if skips:
        parts.append("skipped: " + "; ".join(skips))
    if errors:
        parts.append(f"{len(errors)} count(s) failed: {errors[0]['error']}")
    if counted:
        least = min(counted, key=footprint)
        parts.append(
            f"none fits {HBM_BYTES / 1e9:.0f} GB; the least, "
            "{} x {} {}, accum {}, ".format(*split_of(least),
                                           least["accum_steps"]) +
            f"needs {footprint(least) / 1e9:.1f} GB, "
            f"{least['memory']['argument_size_in_bytes'] / 1e9:.1f} of "
            "them arguments")
    return ", ".join(parts) or "no records"


def record_name(rec: dict) -> str:
    return (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__"
            f"{rec.get('ruleset', 'base')}_a{rec.get('accum_steps', 1)}")


def split_of(rec: dict) -> Tuple[int, int, str]:
    dp, tp = rec["mesh_dp_tp"]
    return dp, tp, rec["ruleset"]


def load(out_dir: str) -> List[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def group(records: Sequence[dict]) -> Dict[Tuple[str, str, int],
                                           List[dict]]:
    """The records by (arch, kind, chips)."""
    kind_of = {s: k for k, s in KIND_SHAPE.items()}
    out: Dict[Tuple[str, str, int], List[dict]] = {}
    for rec in records:
        # an error record has no "chips": its mesh ("2x4xH100") says it
        chips = math.prod(int(n) for n in rec["mesh"].split("x")[:-1])
        out.setdefault((rec["arch"], kind_of[rec["shape"]], chips),
                       []).append(rec)
    return out


def python_table(chosen: Dict[Tuple[str, str, int], dict]) -> str:
    lines = ["_PREFERRED: Dict[int, Dict[Tuple[str, str], Mesh]] = {"]
    for chips in sorted({c for _, _, c in chosen}):
        lines.append(f"    {chips}: {{")
        for (arch, kind, c), rec in sorted(chosen.items()):
            if c != chips:
                continue
            dp, tp, rules = split_of(rec)
            lines.append(f"        # {record_name(rec)}, "
                         f"{rec['roofline']['bound_s']:.6g} s")
            lines.append(f'        ("{arch}", "{kind}"): '
                         f'({dp}, {tp}, "{rules}"),')
        lines.append("    },")
    lines.append("}")
    return "\n".join(lines)


def _cell(win: Optional[dict], second: Optional[dict],
          why: Optional[str]) -> str:
    if win is None:
        return "no entry: " + why
    ro = win["roofline"]
    text = ("{} x {} {}, accum {}: ".format(*split_of(win),
                                           win["accum_steps"]) +
            f"{ro['bound_s']:.6g} s by {ro['dominant']}, "
            f"{footprint(win) / 1e9:.1f} GB")
    if second is not None:
        text += "; runner-up {} x {} {}, accum {}: {:.6g} s".format(
            *split_of(second), second["accum_steps"],
            second["roofline"]["bound_s"])
    return text


def markdown(results: Dict[Tuple[str, str, int], Tuple]) -> str:
    """One row an (arch, kind), one column a number of cards: the chosen
    split, its accum, bound, dominant term and bytes a card, and the
    runner-up; or why there is no entry."""
    chips = sorted({c for _, _, c in results})
    out = ["| arch | kind | " + " | ".join(f"{c} cards" for c in chips) +
           " |", "|---|---|" + "---|" * len(chips)]
    for arch, kind in sorted({(a, k) for a, k, _ in results}):
        cells = [_cell(*results[arch, kind, c]) if (arch, kind, c) in
                 results else "not swept" for c in chips]
        out.append(f"| {arch} | {kind} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def _work(args):
    cand, out_dir = args
    return lower_candidate(cand, out_dir)


def _cost(cand: Candidate) -> Tuple[bool, int]:
    """Train candidates first (they count more microbatches), then by
    fewer data ranks (more accum): a rough order for the workers."""
    arch, kind, chips, dp, tp, _ = cand
    return (kind != "train", dp)


def sweep(archs: Sequence[str], kinds: Sequence[str],
          chips: Sequence[int], out_dir: str, jobs: int) -> List[dict]:
    cands = sorted((c for a in archs for k in kinds for n in chips
                    for c in candidates(a, k, n)), key=_cost)
    print(f"[meshselect] {len(cands)} candidates in {jobs} process(es)",
          flush=True)
    work = [(c, out_dir) for c in cands]
    if jobs <= 1:
        return [r for w in work for r in _work(w)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(jobs) as pool:
        return [r for recs in pool.imap_unordered(_work, work)
                for r in recs]


def results_of(records: Sequence[dict]) -> Dict[Tuple[str, str, int],
                                                Tuple]:
    """(arch, kind, chips) -> (winner, runner-up, why there is none)."""
    out = {}
    for key, recs in group(records).items():
        win, second = choose(recs)
        out[key] = (win, second, None if win else why_none(recs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(ARCH_IDS),
                    choices=list(ARCH_IDS))
    ap.add_argument("--kind", nargs="+", default=list(KIND_SHAPE),
                    choices=list(KIND_SHAPE))
    ap.add_argument("--chips", nargs="+", type=int, default=list(CHIPS))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--from-records", action="store_true",
                    help="choose from the records under --out, counting "
                         "nothing")
    args = ap.parse_args(argv)
    t0 = time.time()
    if args.from_records:
        records = [r for r in load(args.out) if r["arch"] in args.arch]
    else:
        records = sweep(args.arch, args.kind, args.chips, args.out,
                        args.jobs)
    results = {k: v for k, v in results_of(records).items()
               if k[1] in args.kind and k[2] in args.chips}
    chosen = {k: v[0] for k, v in results.items() if v[0] is not None}
    print(f"\n[meshselect] {len(records)} records, {len(chosen)} entries "
          f"in {time.time() - t0:.1f} s; predicted by the dry run, not "
          f"measured\n")
    print(python_table(chosen))
    print()
    print(markdown(results))
    for (arch, kind, chips), (win, _, why) in sorted(results.items()):
        if win is None:
            print(f"[meshselect] no entry for {arch} {kind} on {chips} "
                  f"cards: {why}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
