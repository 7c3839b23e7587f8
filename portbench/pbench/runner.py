"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), then, with the program's state freed, the comparison
with the plain reference; one JSON line as the last line of standard
output, and the numbers compared, each beside its limit, as the last
lines of standard error."""
from __future__ import annotations

import contextlib
import gc
import json
import statistics
import sys
import time
from dataclasses import dataclass
import torch

from . import cells, judge

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Ctx:
    """What a per-layer reader reads: the run (its window's ``stats`` and
    its traced window's ``traced_info``), the trace, and the cell's
    configuration and mix."""
    run: object
    trace: object
    conf: dict
    mix: dict


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or repro
    (the whole name: ``repro_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def limits_for(name: str) -> dict:
    return cells.load_json(cells.BENCH_DIR / "limits" / f"{name}.json")


@contextlib.contextmanager
def still_heap():
    """No cyclic garbage collection inside a measured window: what set-up
    left is collected and frozen first, so that no collection of the whole
    heap lands in one run's window and not in another's."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def allocator_counts() -> dict:
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ("num_device_alloc",
                                         "num_alloc_retries")}


def window_note(stats: dict, before: dict, after: dict) -> str:
    """A line on the window for standard error: its steps' (or rounds')
    times and the allocator's device allocations and retries in it."""
    q = statistics.quantiles(stats["step_s"], n=4) \
        if len(stats["step_s"]) > 1 else stats["step_s"] * 3
    cuts = " ".join(f"{x:.4f}" for x in [min(stats["step_s"]), *q,
                                          max(stats["step_s"])])
    grew = {k: after[k] - before[k] for k in after}
    return (f"portbench: window {len(stats['step_s'])} steps, seconds "
            f"min q1 median q3 max {cuts}; device allocations "
            f"{grew['num_device_alloc']}, retries "
            f"{grew['num_alloc_retries']}")


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device, limits: dict) -> dict:
    """The result of one run of ``cell`` (the contract's keys, then
    ``checks``, each number compared with its limit in ``limits``)."""
    run = cell.driver(cell, seed, device)
    torch.cuda.reset_peak_memory_stats()
    run.setup()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    before = allocator_counts()
    with still_heap():
        run.window(seconds)
    note = window_note(run.stats, before, allocator_counts())
    e2e = run.end_to_end()
    e2e["setup_s"] = setup_s
    t1 = time.perf_counter()
    tr = None
    if traced:
        with still_heap():
            tr = run.traced()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    attempted, failed = run.attempted_failed()
    off = run.off_route()
    per_layer = {}
    if traced:
        ctx = Ctx(run, tr, cell.config, cell.traffic)
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is None:
                print(f"portbench: metric {m['name']} found nothing to read "
                      f"in {cell.name}", file=sys.stderr)
                continue
            per_layer[m["name"]] = {"value": float(v), "unit": m["unit"]}
    run.release()
    ref = run.reference()
    readings = run.readings(ref)
    print(note, file=sys.stderr)
    print(f"portbench: set-up {setup_s:.1f} s, window {t1 - t0:.1f} s, "
          f"traced {t2 - t1:.1f} s, reference "
          f"{time.perf_counter() - t2:.1f} s", file=sys.stderr)
    readings["failed"] = failed
    readings["off_route_launches"] = off
    checks = judge.check(readings, limits)
    compared = {name for name, _, _ in checks}
    if traced:
        metrics = per_layer
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in e2e.items() if k in units}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": judge.passed(checks), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.top_gaps()}
    out["readings"] = {k: v for k, v in readings.items()
                       if k not in compared}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def emit(result: dict) -> None:
    for name, v in result["readings"].items():
        print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
