"""BENCHMARK.json keeps to the benchmark's contract, and each cell's files
are found by name."""
import ast
import json
import re
import shutil

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == TOP
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    for e in bench()[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        for k in e.get("reduced", []):
            assert NAME.match(k), k


def test_entries_have_only_the_contract_keys():
    b = bench()
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    for section, allowed in keys.items():
        names = [e["name"] for e in b[section]]
        assert len(names) == len(set(names))
        for e in b[section]:
            assert set(e) <= allowed, (section, set(e) - allowed)


def test_end_to_end_metrics_and_bounds():
    b = bench()
    assert [m["name"] for m in b["end_to_end"]] == [
        "train_tokens_per_s", "serve_tokens_per_s", "request_ms_p95",
        "setup_s"]
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_one_chip_and_its_files():
    b = bench()
    confs = {c["name"]: c for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        assert w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        used.add(w["config"])
        mix = BENCH / "traffic" / f"{w['traffic']}.json"
        assert mix.is_file()
        driver = json.loads(mix.read_text())["driver"]
        assert (BENCH / "pbench" / f"{driver}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        conf_file = ROOT / confs[w["config"]]["file"]
        assert conf_file.is_file()
        assert json.loads(conf_file.read_text())["name"] == w["config"]
    assert used == set(confs)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    from pbench import cells
    b = bench()
    for w in b["workloads"]:
        cell = cells.load(b, ROOT, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and set(cell.readers) == {
            m["name"] for m in cell.per_layer}


def test_readers_declare_their_entry():
    from pbench import cells
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        mod = cells.load_module(cells.reader_path(m["name"]), "t")
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                    m["moves"])
        assert m["moves"] in e2e
        assert callable(mod.read)


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    """A throwaway configuration, mix, kind of driver and metric, added as
    files and entries beside the committed ones, are found by name; no
    committed file changes."""
    from pbench import cells
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench_dir): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    b = bench()
    conf = json.loads((BENCH / "configs" / "minicpm-2b.json").read_text())
    conf["name"] = "throwaway-model"
    (bench_dir / "configs" / "throwaway-model.json").write_text(
        json.dumps(conf))
    mix = json.loads((BENCH / "traffic" / "serve-docs.json").read_text())
    mix["prompt"]["median"] = 512
    mix["driver"] = "replay"
    (bench_dir / "traffic" / "serve-short.json").write_text(json.dumps(mix))
    (bench_dir / "pbench" / "replay.py").write_text(
        'from .serve import ServeRun\n\n\nclass Run(ServeRun):\n'
        '    """Rounds replayed from a recorded trace."""\n')
    (bench_dir / "metrics" / "rounds_traced.serve.py").write_text(
        'LAYER = "serving loop"\nUNIT = "rounds"\n'
        'MOVES = "serve_tokens_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx.run.traced_info["rounds"]\n')
    b["configs"].append({"name": "throwaway-model", "source": "x",
                         "file": "portbench/configs/throwaway-model.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "throwaway-model.serve-short",
                           "config": "throwaway-model",
                           "traffic": "serve-short", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "rounds_traced.serve", "unit": "rounds",
                           "better": "higher", "source": "program_counter",
                           "layer": "serving loop",
                           "moves": "serve_tokens_per_s",
                           "workloads": ["throwaway-model.serve-short"]})
    cell = cells.load(b, tmp_path, "throwaway-model.serve-short", bench_dir)
    assert cell.config["name"] == "throwaway-model"
    assert cell.traffic["prompt"]["median"] == 512
    assert cell.driver.__name__ == "Run"
    assert cell.driver.__doc__.startswith("Rounds replayed")
    assert "rounds_traced.serve" in cell.readers
    # metrics without "workloads" that move an end-to-end metric of the
    # new cell would find it too; the committed ones all name theirs
    assert {m["name"] for m in cell.per_layer} == {"rounds_traced.serve"}
    after = {p.relative_to(bench_dir): p.read_bytes()
             for p in bench_dir.rglob("*") if p.is_file()
             and p.relative_to(bench_dir) in before}
    assert after == before


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro"), (path, mod)


def test_reference_and_work_import_nothing_of_the_port():
    for sub in ("reference", "work"):
        for path in (BENCH / sub).rglob("*.py"):
            for mod in _imports(path):
                assert not mod.startswith("repro"), (path, mod)
