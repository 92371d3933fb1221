"""The harness finds a cell's files by the names BENCHMARK.json gives
them, and a new configuration, traffic mix or metric needs new files and
entries only."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def bench():
    return spec.load_benchmark(ROOT)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_has_its_files(workload):
    cell = spec.find_cell(bench(), ROOT, workload)
    assert spec.mode_module(cell.traffic).Driver
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in names


def test_names_units_and_entries_keep_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in b[group]:
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert sorted(json.loads((ROOT / c["file"]).read_text())["reduced"]) == sorted(c["reduced"])
    workloads = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", workloads)) <= workloads


def test_new_files_alone_add_a_configuration_a_mix_and_a_metric(tmp_path):
    """A copy of the benchmark grows a cell on a new configuration and a new
    traffic mix, and a new per-layer metric, by added files and entries;
    nothing that was there changes."""
    here = tmp_path / "portbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    before = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file()}
    config = json.loads((here / "configs" / "yi-6b.json").read_text())
    config["arch"]["num_layers"] = 16
    config["num_hidden_layers"] = 16
    config["reduced"] = ["rope_theta", "num_hidden_layers"]
    (here / "configs" / "yi-6b-16L.json").write_text(json.dumps(config))
    mix = json.loads((here / "traffic" / "prefill-docqa.json").read_text())
    mix["lengths"] = {"dist": "lognormal", "median": 512, "sigma": 0.8, "quantiles": 16,
                      "min": 64, "max": 4096}
    (here / "traffic" / "prefill-short.json").write_text(json.dumps(mix))
    (here / "limits" / "yi6b16-prefill-short.json").write_text('{"token_gap": 1.0}')
    (here / "metrics" / "requests.serve.py").write_text(
        "def read(tr):\n    return float(tr.work['requests'])\n")
    b["configs"].append({"name": "yi-6b-16L", "source": "https://huggingface.co/01-ai/Yi-6B",
                         "file": "portbench/configs/yi-6b-16L.json",
                         "reduced": ["rope_theta", "num_hidden_layers"], "why": "a test"})
    b["workloads"].append({"name": "yi6b16-prefill-short", "config": "yi-6b-16L",
                           "traffic": "prefill-short", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "requests.serve", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "prefill step",
                           "moves": "prefill_tokens_per_s", "workloads": ["yi6b16-prefill-short"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "yi6b-prefill-docqa" in m["workloads"]:
            m["workloads"].append("yi6b16-prefill-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.find_cell(spec.load_benchmark(tmp_path), tmp_path, "yi6b16-prefill-short", here)
    assert cell.config["arch"]["num_layers"] == 16 and cell.traffic["lengths"]["median"] == 512
    assert [m["name"] for m in cell.per_layer] == ["requests.serve"]
    assert {m["name"] for m in cell.end_to_end} == {"ttft_p95_ms", "prefill_tokens_per_s",
                                                      "peak_mem_gib", "setup_s"}

    class Tr:
        work = {"requests": 3}
    assert spec.metric_reader("requests.serve", here)(Tr()) == 3.0
    after = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file()
             and p.relative_to(here) in before}
    assert after == before


@pytest.mark.parametrize("lengths,table", [
    ({"dist": "fixed", "length": 3500, "count": 3}, [3500, 3500, 3500]),
    ({"dist": "lognormal", "median": 100, "sigma": 1.0, "quantiles": 4, "min": 40, "max": 200},
     [40, 73, 138, 200]),
])
def test_length_tables(lengths, table):
    from portbench import traffic
    assert traffic.length_table(lengths) == table
