"""The port's command line (``python -m repro_torch``, ``repro_torch.api.cli``)
against the reference's (``python -m repro``), mirroring
``tests/test_cli_smoke.py`` (its quickstart run is
``tests/test_torch_examples.py``'s): each case runs the same arguments
through both ``main`` functions in process and asks for the same exit
code, the same standard output and error (the program name aside), and
equal files; guided search's standard output only without the
``--profile`` table's wall-clock columns. The port's sweeping subcommands
get ``--device cpu``; one case runs the port as ``python -m repro_torch``
in a subprocess and holds its JSON to the in-process run."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.api import cli as R_cli  # noqa: E402
from repro.core import Trace as R_Trace  # noqa: E402
from repro_torch.api import cli as T_cli  # noqa: E402
from repro_torch.core import Trace as T_Trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SWEEPING = ("sweep", "plan")
TINY = ["--arch", "yi-6b", "--hardware", "tpu_v5e_2x2", "--seq-len", "128"]


def _main(cli, argv, capsys):
    """(exit code, stdout, stderr) of ``cli.main(argv)``; argparse's exits
    give their code."""
    try:
        rc = cli.main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


def _both(argv, capsys, files=()):
    """Run ``argv`` through the reference and the port; returns both
    results, each with the text of ``files`` as written by that run."""
    results = []
    for cli, extra in ((R_cli, []), (T_cli, ["--device", "cpu"] if argv[0] in SWEEPING else [])):
        rc, out, err = _main(cli, [*argv, *extra], capsys)
        texts = [Path(f).read_text() if Path(f).is_file() else None for f in files]
        for f in files:
            Path(f).unlink(missing_ok=True)
        # argparse wraps its usage lines by the program name's length
        err = " ".join(err.replace("python -m repro_torch", "python -m repro").split())
        results.append((rc, out, err, texts))
    return results


def _json_tail(out):
    return json.loads(out[out.index("{"):])


CASES = {
    "simulate": ["simulate", *TINY, "--pp", "2", "--dp", "2", "--global-batch", "8",
                 "--json", "-"],
    "simulate offload": ["simulate", *TINY, "--pp", "2", "--dp", "2", "--global-batch", "8",
                         "--activation-offload", "--json", "-"],
    "simulate fast": ["simulate", *TINY, "--pp", "2", "--dp", "2", "--global-batch", "8",
                      "--engine", "auto", "--metrics", "--json", "-"],
    "plan": ["plan", *TINY, "--global-batch", "16", "--max-plans", "4"],
    "plan auto": ["plan", *TINY, "--global-batch", "16", "--max-plans", "4", "--engine", "auto",
                  "--best-only", "--json", "-"],
    "sweep hardware variants": ["sweep", *TINY, "--global-batch", "8", "--max-plans", "3",
                                "--microbatch-sizes", "1", "--layouts", "s_shape",
                                "--hw-flops", "100e12", "197e12", "--json", "-"],
    "sweep batched": ["sweep", *TINY, "--global-batch", "8", "--max-plans", "3",
                      "--microbatch-sizes", "1", "--hw-flops", "100e12", "197e12",
                      "--hw-dram-bw", "400e9", "819e9", "--engine", "auto", "--json", "-"],
    "codesign json needs hw axes": ["plan", *TINY, "--global-batch", "8", "--max-plans", "3",
                                    "--codesign-json", "-"],
    "budget needs a strategy": ["sweep", *TINY, "--global-batch", "8", "--max-plans", "3",
                                "--search-budget", "2"],
    "unknown enum": ["simulate", "--arch", "yi-6b", "--schedule", "2f2b"],
    "hardware dump": ["hardware", "--hardware", "wafer_scale"],
    "torus dump": ["hardware", "--hardware", "tpu_v5e_torus_2x2"],
    "d_model": ["hardware", "--hardware", "a100x8", "--d-model", "20480"],
    "d_model on a preset": ["hardware", "--hardware", "wafer_scale", "--d-model", "20480"],
    "fabric dump": ["fabric", "--preset", "rack_2x2x2"],
    "serve-plan": ["serve-plan", *TINY[:4], "--batch", "4", "--context-len", "128",
                   "--json", "-"],
    "serve-plan infeasible": ["serve-plan", *TINY[:4], "--batch", "4", "--context-len", "128",
                              "--memory-cap", "1e6"],
    "serve-sim bursty": ["serve-sim", "--arch", "hymba-1.5b", "--hardware", "grayskull",
                         "--workload", "bursty", "--rate", "2", "--num-requests", "10",
                         "--prompt-mean", "64", "--decode-mean", "8", "--max-batch", "4",
                         "--ctx-bucket", "128", "--seed", "3", "--json", "-"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_equals_reference(case, capsys):
    ref, port = _both(CASES[case], capsys)
    assert port == ref
    rc, out, err, _ = port
    if case.startswith("simulate") and case != "simulate fast" or case == "plan auto":
        assert rc == 0 and _json_tail(out)["throughput"] > 0
    if case == "simulate offload":
        assert _json_tail(out)["plan"]["activation_offload"] is True
    if case == "plan":
        assert "best plan for yi-6b" in out
    if case.startswith("sweep"):
        variants = 2 if case == "sweep hardware variants" else 4
        assert len({r["hardware"] for r in _json_tail(out)["runs"]}) == variants
    if case == "codesign json needs hw axes":
        assert rc == 2 and "--hw-*" in err
    if case == "budget needs a strategy":
        assert rc == 2 and "--search" in err
    if case == "unknown enum":
        assert rc != 0 and "invalid" in err
    if case == "torus dump":
        assert json.loads(out)["topology"]["torus"] is True
    if case == "d_model on a preset":
        assert rc != 0 and "a100x<N>" in err
    if case == "serve-plan":
        assert "best serving split" in out
    if case == "serve-plan infeasible":
        assert rc == 1 and "no feasible serving split" in err and "cap by" in err


def test_cli_sweep_pooled(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    ref, port = _both(["sweep", *TINY, "--global-batch", "16", "--max-plans", "6",
                       "--microbatch-sizes", "1", "2", "--workers", "2", "--engine", "auto",
                       "--json", str(out)], capsys, files=[out])
    assert port == ref
    report = json.loads(port[3][0])
    assert report["executor"] == "process[2]"
    thpts = [r["throughput"] for r in report["runs"]]
    assert thpts and thpts == sorted(thpts, reverse=True)


def test_cli_simulate_trace_export(tmp_path, capsys):
    out, npz = tmp_path / "trace.json", tmp_path / "trace.npz"
    argv = ["simulate", *TINY, "--pp", "2", "--dp", "2", "--global-batch", "8",
            "--trace-out", str(out), "--trace-npz", str(npz)]
    traces = []
    for cli, Trace in ((R_cli, R_Trace), (T_cli, T_Trace)):
        assert _main(cli, argv, capsys)[0] == 0
        traces.append((json.loads(out.read_text()), Trace.from_npz(npz).to_bytes()))
    assert traces[1] == traces[0]
    slices = [e for e in traces[1][0]["traceEvents"] if e.get("ph") == "X"]
    cats = {e["cat"] for e in slices}
    assert {"FD", "BD", "GU"} <= cats and cats & {"NOC", "DRAM"}
    assert len(T_Trace.from_bytes(traces[1][1])) == len(slices)


def test_cli_hardware_json_and_codesign_round_trip(tmp_path, capsys):
    hw_json, best = tmp_path / "hw.json", tmp_path / "codesign.json"
    rc, out, _ = _main(T_cli, ["hardware", "--hardware", "wafer_scale"], capsys)
    hw_json.write_text(out)
    ref, port = _both(["simulate", "--arch", "yi-6b", "--hardware-json", str(hw_json), "--pp",
                       "4", "--dp", "2", "--tp", "2", "--global-batch", "16", "--seq-len", "128",
                       "--json", "-"], capsys)
    assert port == ref and _json_tail(port[1])["hardware"] == "wafer_scale"
    ref, port = _both(["plan", *TINY, "--global-batch", "8", "--max-plans", "3",
                       "--microbatch-sizes", "1", "--layouts", "s_shape",
                       "--hw-flops", "100e12", "197e12", "--codesign-json", str(best)],
                      capsys, files=[best])
    assert port == ref and "co-design over 2 variants" in port[1]
    doc = json.loads(port[3][0])
    assert doc["hardware"]["tile"]["flops"] == 197e12 and doc["num_hardware"] == 2
    hw_json.write_text(json.dumps(doc["hardware"]))
    rc, out, err = _main(T_cli, ["simulate", "--arch", "yi-6b", "--hardware-json", str(hw_json),
                                 "--tp", "4", "--global-batch", "8", "--seq-len", "128"], capsys)
    assert rc == 0, err


def test_cli_trace_diff(tmp_path, capsys):
    npzs = []
    for pp, dp in ((2, 2), (4, 1)):
        npz = tmp_path / f"pp{pp}.npz"
        assert _main(T_cli, ["simulate", *TINY, "--pp", str(pp), "--dp", str(dp),
                             "--global-batch", "8", "--trace-npz", str(npz)], capsys)[0] == 0
        npzs.append(str(npz))
    out = tmp_path / "diff.json"
    ref, port = _both(["trace-diff", *npzs, "--json", str(out)], capsys, files=[out])
    assert port == ref
    doc = json.loads(port[3][0])
    assert set(doc["stage_busy"]) == {"0", "1", "2", "3"}
    bad = tmp_path / "chrome.json"
    bad.write_text(json.dumps({"traceEvents": []}))
    ref, port = _both(["trace-diff", str(bad), str(bad)], capsys)
    assert port == ref and port[0] == 2 and "columnar" in port[2]


def test_cli_serve_sim_and_replay(tmp_path, capsys):
    report, trace, workload = (tmp_path / n for n in ("report.json", "trace.json", "wl.json"))
    args = ["serve-sim", "--arch", "hymba-1.5b", "--hardware", "grayskull", "--rate", "2",
            "--num-requests", "10", "--prompt-mean", "64", "--decode-mean", "8",
            "--max-batch", "4", "--ctx-bucket", "128", "--seed", "3"]
    ref, port = _both([*args, "--json", str(report), "--trace-out", str(trace),
                       "--workload-out", str(workload)], capsys,
                      files=[report, trace, workload])
    assert port == ref
    assert "goodput:" in port[1] and "TTFT" in port[1]
    doc = json.loads(port[3][0])
    assert doc["completed"] == 10
    workload.write_text(port[3][2])
    ref, port = _both(["serve-sim", "--arch", "hymba-1.5b", "--hardware", "grayskull",
                       "--replay", str(workload), "--max-batch", "4", "--ctx-bucket", "128",
                       "--json", "-"], capsys)
    assert port == ref
    replay = _json_tail(port[1])
    assert replay.pop("offered_rate") > 0
    doc.pop("offered_rate")
    assert replay == doc


def test_cli_plan_guided_search(tmp_path, capsys):
    """`plan --search sh` runs the guided co-design loop: budgeted
    full-fidelity sims, a search accounting note, and a report carrying
    the nested SearchReport, as the reference's does."""
    out = tmp_path / "guided.json"
    ref, port = _both(["plan", *TINY, "--global-batch", "8", "--max-plans", "3",
                       "--microbatch-sizes", "1", "--layouts", "s_shape",
                       "--hw-flops", "100e12", "197e12", "--search", "sh",
                       "--search-budget", "2", "--seed", "0", "--json", str(out)],
                      capsys, files=[out])
    assert port == ref and port[0] == 0
    assert "[search sh (seed 0): " in port[1]
    doc = json.loads(port[3][0])
    search = doc["search"]
    assert search["strategy"] == "sh" and search["seed"] == 0
    assert search["full_fidelity_sims"] <= 2
    assert search["rungs"] and search["best_curve"]
    # faster tiles still win under the budgeted search
    assert "197T" in doc["runs"][0]["hardware"]


def _without_times(out):
    """A sweep's output with ``--profile``'s table less its wall-clock
    columns (the milliseconds, the only words there with a point)."""
    head, table = out.split("[batched fast tier profile]")
    return head, [" ".join(w for w in line.split() if "." not in w)
                  for line in table.splitlines()]


def test_cli_sweep_guided_search_deterministic(capsys):
    """A fixed-seed guided sweep prints the same report twice and the
    reference's; with ``--profile`` one row a rung follows the phase
    table."""
    argv = ["sweep", *TINY, "--global-batch", "8", "--max-plans", "4", "--microbatch-sizes",
            "1", "--search", "random", "--search-budget", "3", "--seed", "7", "--json", "-"]
    ref, port = _both(argv, capsys)
    assert port == ref and port[0] == 0
    again = _main(T_cli, [*argv, "--device", "cpu"], capsys)
    assert _json_tail(again[1]) == _json_tail(port[1])
    assert "[search random (seed 7): " in port[1]
    ref, port = _both(["sweep", *TINY, "--global-batch", "8", "--max-plans", "4",
                       "--microbatch-sizes", "1", "--hw-flops", "100e12", "197e12",
                       "--search", "sh", "--search-budget", "2", "--seed", "0", "--profile"],
                      capsys)
    assert port[0] == ref[0] == 0 and port[2] == ref[2]
    assert _without_times(port[1]) == _without_times(ref[1])
    rows = port[1][port[1].index("      rung   jobs  batched"):].splitlines()[1:]
    assert len(rows) == 3 and [r.split()[0] for r in rows] == ["0", "1", "2"]


def test_cli_sweep_without_a_device_means_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        T_cli.main(["sweep", *TINY, "--global-batch", "8", "--max-plans", "2",
                    "--engine", "auto"])


def test_python_m_repro_torch_equals_in_process(capsys):
    argv = ["sweep", *TINY, "--global-batch", "8", "--max-plans", "3", "--microbatch-sizes",
            "1", "--hw-flops", "100e12", "197e12", "--engine", "auto", "--device", "cpu",
            "--json", "-"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch", *argv], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rc, out, _ = _main(T_cli, argv, capsys)
    assert rc == 0 and proc.stdout == out
