"""StreamFlow-style command line.

``python -m repro_torch.cli check <file> [--plan] [--json]`` loads a
StreamFlow file, runs the static checker (forced on, regardless of the
document's ``check:`` key) and dry-runs every workflow to its invocation
plan — without deploying or executing anything.

``python -m repro_torch.cli analyze <file> [--json]`` additionally runs the
plan-time semantic analyzer (``repro_torch.core.analyzer``): SF3xx
deadlock/satisfiability/reachability proofs plus the static cost report
(critical path, makespan lower bound, per-link byte volumes).

A path needs PyYAML (a dict document loads without it, through
``repro_torch.core.load_streamflow_file``).  Both exit 0 on a clean document and 1 otherwise, printing one
tab-separated ``CODE<TAB>location<TAB>message`` line per diagnostic so
shell pipelines and CI can grep the output by code; ``--json`` switches
to one machine-readable JSON object on stdout (shared shape:
``{"ok": bool, "diagnostics": [...], ...}``).  ``analyze`` exits 1 only
on *errors* — warnings print (or serialize) but do not fail the command.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def _diag_rows(diagnostics, severity_of):
    return [{"code": d.code, "severity": severity_of(d.code),
             "location": d.location, "message": d.message}
            for d in diagnostics]


def _emit_load_failure(args, exc) -> int:
    """Shared check/analyze failure output for unloadable documents."""
    from repro_torch.core.checker import WorkflowCheckError
    if isinstance(exc, WorkflowCheckError):
        if args.json:
            json.dump({"ok": False, "file": args.file,
                       "diagnostics": _diag_rows(exc.diagnostics,
                                                 lambda c: "error")},
                      sys.stdout, indent=2, sort_keys=True)
            print()
        else:
            for d in exc.diagnostics:
                print(f"{d.code}\t{d.location}\t{d.message}")
            print(f"FAIL: {args.file}: "
                  f"{len(exc.diagnostics)} diagnostic(s)")
        return 1
    if args.json:
        json.dump({"ok": False, "file": args.file,
                   "diagnostics": [{"code": "SCHEMA", "severity": "error",
                                    "location": "$",
                                    "message": str(exc)}]},
                  sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        print(f"SCHEMA\t$\t{exc}")
        print(f"FAIL: {args.file}: not loadable")
    return 1


def _cmd_check(args) -> int:
    from repro_torch.core.checker import WorkflowCheckError, dry_run
    from repro_torch.core.streamflow_file import StreamFlowFileError, load
    try:
        cfg = load(args.file, check=True)
    except (WorkflowCheckError, StreamFlowFileError, OSError) as e:
        return _emit_load_failure(args, e)

    plans = {name: dry_run(entry) for name, entry in cfg.workflows.items()}
    n_inv = sum(len(p["invocations"]) for p in plans.values())
    if args.json:
        out = {"ok": True, "file": args.file, "diagnostics": [],
               "workflows": len(plans), "invocations": n_inv}
        if args.plan:
            out["plans"] = plans
        json.dump(out, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    if args.plan:
        json.dump(plans, sys.stdout, indent=2, sort_keys=True)
        print()
    print(f"OK: {args.file}: {len(plans)} workflow(s), "
          f"{n_inv} invocation(s), 0 diagnostics")
    return 0


def _cmd_analyze(args) -> int:
    from repro_torch.core import analyzer
    from repro_torch.core.checker import WorkflowCheckError
    from repro_torch.core.streamflow_file import StreamFlowFileError, load
    try:
        cfg = load(args.file, check=True)
    except (WorkflowCheckError, StreamFlowFileError, OSError) as e:
        return _emit_load_failure(args, e)

    report = analyzer.analyze(cfg)
    errors, warns = report.errors(), report.warnings()
    if args.json:
        out = report.to_dict()
        out.update(ok=not errors, file=args.file)
        json.dump(out, sys.stdout, indent=2, sort_keys=True)
        print()
        return 1 if errors else 0
    for d in report.diagnostics:
        sev = analyzer.SEVERITY.get(d.code, "error")
        print(f"{d.code}\t{d.location}\t[{sev}] {d.message}")
    for name, cost in report.cost.items():
        path = " -> ".join(cost["critical_path"]) or "(empty)"
        print(f"{name}: {cost['n_invocations']} invocation(s), "
              f"critical path {cost['critical_path_s']}s via {path}, "
              f"makespan lower bound {cost['makespan_lower_bound_s']}s, "
              f"max parallel slots {cost['max_parallel_slots']}, "
              f"mgmt bytes {cost['mgmt_bytes']}")
    if errors:
        print(f"FAIL: {args.file}: {len(errors)} error(s), "
              f"{len(warns)} warning(s)")
        return 1
    print(f"OK: {args.file}: {len(report.cost)} workflow(s) analyzed, "
          f"0 errors, {len(warns)} warning(s)")
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="streamflow",
        description="StreamFlow file tooling (the PyTorch port's engine)")
    sub = parser.add_subparsers(dest="command", required=True)
    check = sub.add_parser(
        "check",
        help="statically check a StreamFlow file and dry-run its plans")
    check.add_argument("file", help="path to the StreamFlow YAML file")
    check.add_argument("--plan", action="store_true",
                       help="print every workflow's invocation plan "
                            "(JSON) before the verdict")
    check.add_argument("--json", action="store_true",
                       help="machine-readable JSON output")
    analyze = sub.add_parser(
        "analyze",
        help="run the plan-time semantic analyzer (SF3xx proofs + "
             "static cost prediction) over a StreamFlow file")
    analyze.add_argument("file", help="path to the StreamFlow YAML file")
    analyze.add_argument("--json", action="store_true",
                         help="machine-readable JSON output")
    args = parser.parse_args(argv)
    if args.command == "check":
        return _cmd_check(args)
    if args.command == "analyze":
        return _cmd_analyze(args)
    parser.error(f"unknown command {args.command!r}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
