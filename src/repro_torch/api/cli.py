"""``python -m repro_torch`` — simulate / sweep / plan / hardware from the shell.

    python -m repro_torch simulate --arch yi-6b --hardware wafer_scale \
        --pp 4 --dp 2 --tp 2 --global-batch 64
    python -m repro_torch sweep --arch yi-6b --hardware grayskull \
        --global-batch 64 --max-plans 24 --workers 4 --json sweep.json
    python -m repro_torch sweep --arch yi-6b --hardware wafer_scale \
        --hw-flops 8e12 16e12 --hw-mesh 4x4 5x4 --global-batch 64 \
        --engine auto --device cpu
    python -m repro_torch plan --arch dbrx-132b --hardware wafer_scale
    python -m repro_torch plan --arch yi-6b --hardware wafer_scale \
        --hw-flops 8e12 16e12 --hw-mesh 5x4 4x4 --codesign-json best_hw.json
    python -m repro_torch hardware --hardware wafer_scale > wafer.json
    python -m repro_torch simulate --arch yi-6b --hardware-json wafer.json ...
    python -m repro_torch trace-diff base.npz variant.npz
    python -m repro_torch sweep --arch yi-6b ... --metrics --json sweep.json
    python -m repro_torch metrics sweep.json

Every enum-valued flag takes the typed values (``--schedule 1f1b``,
``--noc-mode macro``); hardware is a preset name, an ``a100x<N>`` /
``tpu_v5e_<R>x<C>`` parameterized name, or a ``--hardware-json`` file
(the schema ``python -m repro_torch hardware`` emits). Outputs are the
RunReport / SweepReport JSON documents when ``--json`` is given, human
tables otherwise.

``sweep`` and ``plan`` take ``--device {cuda,cpu}``: the batched fast
tier (``--engine auto`` / ``fast``) replays on the card by default and
stops with an error without one; ``--device cpu`` asks for the host.
Everything else is host code, ``serve-sim`` and ``serve-plan`` too (the
latter sweeps on the event engine). Guided ``--search`` is not ported
yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Tuple

from ..configs import list_archs
from ..core.enums import BoundaryMode, Layout, NoCMode, Schedule
from ..core.hardware import HardwareSpec
from ..core.parallelism import ParallelPlan
from .experiment import (
    Experiment,
    HARDWARE_PRESETS,
    HardwareSearchSpace,
    SearchSpace,
    resolve_hardware,
)
from .report import refuse_search

__all__ = ["main"]


def _mesh_shape(s: str) -> Tuple[int, int]:
    try:
        r, c = s.lower().split("x")
        return (int(r), int(c))
    except ValueError:
        raise argparse.ArgumentTypeError(f"mesh shape must be RxC, got {s!r}")


def _add_hardware(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--hardware", default="wafer_scale",
                    help=f"preset: {', '.join(sorted(HARDWARE_PRESETS))}, "
                         "a100x<N>, or tpu_v5e_<R>x<C>")
    ap.add_argument("--hardware-json", type=Path, default=None, metavar="FILE",
                    help="load the HardwareSpec from this JSON file "
                         "(overrides --hardware; schema: "
                         "`python -m repro_torch hardware`)")
    ap.add_argument("--d-model", type=int, default=None,
                    help="calibrate the a100 sustained-GEMM efficiency curve "
                         "at this hidden size (a100x<N> only)")
    ap.add_argument("--fabric", default=None, metavar="PRESET",
                    help="attach a scale-out fabric preset (board_pair, "
                         "cluster_2x2, rack_2x2x2) replicating the chip into "
                         "a multi-chip cluster")
    ap.add_argument("--fabric-json", type=Path, default=None, metavar="FILE",
                    help="attach the FabricSpec in this JSON file (overrides "
                         "--fabric; schema: `python -m repro_torch fabric`)")


def _resolve_fabric_args(args):
    """FabricSpec from --fabric/--fabric-json (None when neither given)."""
    if getattr(args, "fabric_json", None) is not None:
        from ..fabric import FabricSpec
        return FabricSpec.from_json(args.fabric_json.read_text())
    if getattr(args, "fabric", None) is not None:
        from ..fabric import FABRIC_PRESETS
        builder = FABRIC_PRESETS.get(args.fabric)
        if builder is None:
            raise ValueError(f"unknown fabric preset {args.fabric!r}; "
                             f"known: {', '.join(sorted(FABRIC_PRESETS))}")
        return builder()
    return None


def _resolve_hardware_args(args) -> "HardwareSpec | str":
    fabric = _resolve_fabric_args(args)
    if args.hardware_json is not None:
        if args.d_model is not None:
            raise ValueError("--d-model calibrates the a100x<N> preset; it "
                             "cannot recalibrate a --hardware-json file")
        hw = HardwareSpec.from_json(args.hardware_json.read_text())
    elif args.d_model is not None:
        hw = resolve_hardware(args.hardware, d_model=args.d_model)
    elif fabric is not None:
        hw = resolve_hardware(args.hardware)
    else:
        return args.hardware
    if fabric is not None:
        hw = hw.with_(fabric=fabric)
    return hw


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", required=True,
                    help=f"arch-config name (e.g. {', '.join(list_archs()[:3])}, "
                         "T-18B, ...)")
    _add_hardware(ap)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--inference", action="store_true",
                    help="simulate an inference pipeline instead of training")
    ap.add_argument("--noc-mode", type=NoCMode, choices=list(NoCMode),
                    default=NoCMode.MACRO)
    ap.add_argument("--boundary-mode", type=BoundaryMode,
                    choices=list(BoundaryMode), default=BoundaryMode.PAIRWISE)
    ap.add_argument("--json", type=Path, default=None, metavar="FILE",
                    help="write the report JSON here ('-' for stdout)")


def _add_plan_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--schedule", type=Schedule, choices=list(Schedule),
                    default=Schedule.ONE_F_ONE_B)
    ap.add_argument("--layout", type=Layout, choices=list(Layout),
                    default=Layout.S_SHAPE)
    ap.add_argument("--activation-offload", action="store_true",
                    help="park saved activations off-device between FD and "
                         "BD (smaller footprint, extra DRAM traffic)")
    ap.add_argument("--trace-out", type=Path, default=None, metavar="FILE",
                    help="write the run's event timeline as Chrome/Perfetto "
                         "traceEvents JSON (open in chrome://tracing or "
                         "ui.perfetto.dev; '-' for stdout)")
    ap.add_argument("--trace-npz", type=Path, default=None, metavar="FILE",
                    help="write the columnar trace as a compressed .npz "
                         "archive (needs numpy)")
    ap.add_argument("--engine", choices=["auto", "event", "fast"],
                    default="event",
                    help="simulator tier: 'event' = generator/heap kernel, "
                         "'auto' = bit-identical closed-form fast path with "
                         "fallback on contention, 'fast' = fast path or fail "
                         "(see docs/simulator.md)")


def _add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the batched fast tier (--engine auto/fast) "
                         "replays its groups: the card (default; an error "
                         "without one) or the CPU")


def _add_sweep_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--max-plans", type=int, default=64)
    ap.add_argument("--microbatch-sizes", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--schedules", type=Schedule, nargs="+",
                    choices=list(Schedule), default=[Schedule.ONE_F_ONE_B])
    ap.add_argument("--layouts", type=Layout, nargs="+",
                    choices=list(Layout), default=[Layout.S_SHAPE, Layout.LINE])
    ap.add_argument("--interleave", type=int, nargs="+", default=[1],
                    help="virtual-stage degrees (interleaved 1F1B)")
    ap.add_argument("--zero-stages", type=int, nargs="+", default=[0],
                    choices=[0, 1, 2, 3], help="ZeRO optimizer-sharding stages")
    ap.add_argument("--comm-strategies", type=int, nargs="+", default=[1],
                    choices=[1, 2],
                    help="inter-tile-group boundary strategies (Fig. 11; "
                         "needs --boundary-mode strategy to differ)")
    ap.add_argument("--activation-offload", type=int, nargs="+", default=[0],
                    choices=[0, 1],
                    help="activation-offload axis (0 = resident, 1 = park "
                         "saved activations off-device; sweep both with "
                         "'0 1')")
    ap.add_argument("--memory-cap", type=float, default=None,
                    help="bytes per tile; infeasible plans pruned pre-simulation")
    ap.add_argument("--engine", choices=["auto", "event", "fast"],
                    default="event",
                    help="simulator tier per candidate: 'event' = generator/"
                         "heap kernel, 'auto'/'fast' = bit-identical fast "
                         "tier, evaluated in batches across the sweep on "
                         "--device (see docs/simulator.md)")
    ap.add_argument("--profile", action="store_true",
                    help="print (and embed in --json artifacts) the batched "
                         "fast tier's per-phase timing table: compile / "
                         "batch-eval / validate / fallback")
    ap.add_argument("--workers", type=int, default=0,
                    help="0 = serial, N = process pool of N, -1 = all cores "
                         "(spawned workers; on the card each opens its own "
                         "CUDA context)")
    _add_device(ap)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--search", default="exhaustive",
                    choices=["exhaustive", "random", "sh", "evolve"],
                    help="search strategy: exhaustive evaluates every "
                         "candidate; guided search (random/sh/evolve) is the "
                         "port's next slice and exits with an error")
    ap.add_argument("--search-budget", type=int, default=None, metavar="N",
                    help="max full-fidelity simulations for guided search "
                         "(default: a fifth of the space)")
    ap.add_argument("--seed", type=int, default=None,
                    help="guided-search RNG seed (fixed seed = "
                         "bit-reproducible run, serial or pooled; "
                         "default 0)")
    hw = ap.add_argument_group(
        "hardware search (cross the plan sweep with hardware variants)")
    hw.add_argument("--hw-flops", type=float, nargs="+", default=[],
                    help="per-tile peak FLOP/s values to sweep")
    hw.add_argument("--hw-sram", type=float, nargs="+", default=[],
                    help="per-tile SRAM bytes to sweep")
    hw.add_argument("--hw-intra-bw", type=float, nargs="+", default=[],
                    help="intra-tile NoC bandwidths (bytes/s) to sweep")
    hw.add_argument("--hw-inter-bw", type=float, nargs="+", default=[],
                    help="inter-tile NoC bandwidths (bytes/s) to sweep")
    hw.add_argument("--hw-mesh", type=_mesh_shape, nargs="+", default=[],
                    metavar="RxC", help="mesh shapes to sweep (e.g. 8x8 16x16)")
    hw.add_argument("--hw-dram-channels", type=int, nargs="+", default=[],
                    help="DRAM channel counts to sweep")
    hw.add_argument("--hw-dram-bw", type=float, nargs="+", default=[],
                    help="DRAM channel bandwidths (bytes/s) to sweep")
    hw.add_argument("--hw-fabric-bw", type=float, nargs="+", default=[],
                    help="outermost fabric-level bandwidths (bytes/s) to "
                         "sweep (hardware must carry a fabric: --fabric / "
                         "--fabric-json)")
    hw.add_argument("--hw-fabric-coll", nargs="+", default=[],
                    choices=["hierarchical", "ring", "tree", "hd"],
                    help="cross-chip collective families to sweep")
    hw.add_argument("--hw-max-specs", type=int, default=32,
                    help="cap on enumerated hardware variants")


def _hardware_search(args) -> Optional[HardwareSearchSpace]:
    space = HardwareSearchSpace(
        tile_flops=tuple(args.hw_flops),
        sram_bytes=tuple(args.hw_sram),
        intra_bw=tuple(args.hw_intra_bw),
        inter_bw=tuple(args.hw_inter_bw),
        mesh_shapes=tuple(args.hw_mesh),
        dram_channels=tuple(args.hw_dram_channels),
        dram_bandwidth=tuple(args.hw_dram_bw),
        fabric_bw=tuple(args.hw_fabric_bw),
        fabric_collectives=tuple(args.hw_fabric_coll),
        max_specs=args.hw_max_specs,
    )
    has_axes = any((space.tile_flops, space.sram_bytes, space.intra_bw,
                    space.inter_bw, space.mesh_shapes, space.dram_channels,
                    space.dram_bandwidth, space.fabric_bw,
                    space.fabric_collectives))
    return space if has_axes else None


def _emit(report, json_target: Optional[Path]) -> None:
    if json_target is None:
        return
    text = report.to_json(indent=2)
    if str(json_target) == "-":
        print(text)
    else:
        json_target.write_text(text + "\n")
        print(f"[report written to {json_target}]")


def _add_metrics_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--metrics", action="store_true",
                    help="record the repro_torch.obs metrics registry (sim-domain "
                         "roofline/bubble/traffic plus host-domain tier and "
                         "timing counters) and print its summary; rides in "
                         "--json reports under 'metrics' "
                         "(see docs/observability.md)")
    ap.add_argument("--metrics-out", type=Path, default=None, metavar="FILE",
                    help="write the metrics document JSON here ('-' for "
                         "stdout; implies --metrics)")


def _want_metrics(args) -> bool:
    return bool(getattr(args, "metrics", False)
                or getattr(args, "metrics_out", None) is not None)


def _emit_metrics(report, args) -> None:
    if not _want_metrics(args):
        return
    metrics = getattr(report, "metrics", None)
    if metrics is None:
        return                          # e.g. a sweep with zero runs
    out = getattr(args, "metrics_out", None)
    if out is not None:
        text = json.dumps(metrics, indent=2)
        if str(out) == "-":
            print(text)
        else:
            out.write_text(text + "\n")
            print(f"[metrics written to {out}]")
    else:
        from ..obs.registry import summarize_metrics
        print(summarize_metrics(
            metrics, title=f"{report.arch} on {report.hardware}"))


def _cmd_simulate(args) -> int:
    plan = ParallelPlan(pp=args.pp, dp=args.dp, tp=args.tp,
                        microbatch=args.microbatch,
                        global_batch=args.global_batch,
                        schedule=args.schedule, layout=args.layout,
                        activation_offload=args.activation_offload,
                        training=not args.inference)
    want_trace = args.trace_out is not None or args.trace_npz is not None
    if args.trace_npz is not None:
        from ..core import trace as trace_mod
        if trace_mod._np is None:       # fail before paying for the sim
            raise ValueError("--trace-npz needs numpy (this install runs "
                             "the dependency-free core); use --trace-out")
    exp = Experiment(arch=args.arch, hardware=_resolve_hardware_args(args),
                     plan=plan, seq_len=args.seq_len,
                     global_batch=args.global_batch,
                     training=not args.inference, noc_mode=args.noc_mode,
                     boundary_mode=args.boundary_mode,
                     collect_timeline=want_trace,
                     engine=args.engine,
                     metrics=_want_metrics(args))
    report = exp.run()
    print(f"{report.arch} on {report.hardware}: {report.summary()}")
    if want_trace:
        _emit_trace(report, args)
    _emit_metrics(report, args)
    _emit(report, args.json)
    return 0


def _emit_trace(report, args) -> None:
    from ..core.trace import chrome_trace
    trace = report.trace
    if trace is None:       # defensive: collect_timeline was on
        raise ValueError("simulation produced no trace")
    if args.trace_out is not None:
        from ..obs.tracks import activity_counters, metrics_counters
        counters = activity_counters(trace)
        counters.update(metrics_counters(getattr(report, "metrics", None),
                                         trace.total_time))
        doc = chrome_trace(trace, label=f"{report.arch}@{report.hardware}",
                           counters=counters)
        text = json.dumps(doc)
        if str(args.trace_out) == "-":
            print(text)
        else:
            args.trace_out.write_text(text + "\n")
            summary = report.trace_summary()
            print(f"[trace written to {args.trace_out}: "
                  f"{summary['events']} events, "
                  f"bubble {summary['bubble_fraction']:.1%}]")
    if args.trace_npz is not None:
        trace.to_npz(args.trace_npz)
        print(f"[columnar trace written to {args.trace_npz}]")


def _make_sweep_experiment(args) -> Experiment:
    search = SearchSpace(schedules=tuple(args.schedules),
                         layouts=tuple(args.layouts),
                         microbatch_sizes=tuple(args.microbatch_sizes),
                         interleave=tuple(args.interleave),
                         zero_stages=tuple(args.zero_stages),
                         comm_strategies=tuple(args.comm_strategies),
                         activation_offload=tuple(
                             bool(v) for v in args.activation_offload),
                         max_plans=args.max_plans)
    return Experiment(arch=args.arch, hardware=_resolve_hardware_args(args),
                      search=search, hardware_search=_hardware_search(args),
                      seq_len=args.seq_len, global_batch=args.global_batch,
                      training=not args.inference, noc_mode=args.noc_mode,
                      boundary_mode=args.boundary_mode,
                      memory_cap=args.memory_cap,
                      engine=getattr(args, "engine", "event"),
                      metrics=_want_metrics(args))


def _sweep_call_kwargs(args) -> dict:
    kw = {"workers": None if args.workers < 0 else args.workers,
          "profile": getattr(args, "profile", False),
          "device": args.device}
    if args.search != "exhaustive":
        refuse_search(f"--search {args.search}")
    elif args.search_budget is not None or args.seed is not None:
        # never let a "capped" sweep silently run the whole product
        raise ValueError("--search-budget/--seed only apply to guided "
                         "search; add --search {random,sh,evolve}")
    return kw


# (phase label, microseconds key, jobs key) rows of the --profile table;
# keys match repro_torch.core.fastbatch.run_fast_batch's profile dict plus the
# sweep layer's fallback accounting
_PROFILE_PHASES = (
    ("compile", "compile_us", "batched_jobs"),
    ("batch-eval", "eval_us", "batched_jobs"),
    ("validate", "validate_us", "contended_jobs"),
    ("fallback", "fallback_us", "fallback_jobs"),
)


def _print_profile(report) -> None:
    prof = getattr(report, "profile", None)
    if prof is None:
        return
    print("[batched fast tier profile]")
    print(f"  {'phase':>10s} {'time (ms)':>10s} {'jobs':>6s}")
    for label, tkey, jkey in _PROFILE_PHASES:
        print(f"  {label:>10s} {prof.get(tkey, 0) / 1e3:>10.2f} "
              f"{prof.get(jkey, 0):>6d}")
    print(f"  {prof.get('groups', 0)} chain-shape group(s) over "
          f"{prof.get('batched_jobs', 0)} batched job(s); "
          f"{prof.get('scalar_jobs', 0)} scalar, "
          f"{prof.get('ineligible_jobs', 0)} ineligible")


def _cmd_sweep(args) -> int:
    exp = _make_sweep_experiment(args)
    report = exp.sweep(**_sweep_call_kwargs(args))
    hw_note = (f", {report.num_hardware} hardware variants"
               if report.num_hardware > 1 else "")
    print(f"== sweep: {report.arch} on {report.hardware} "
          f"({report.executor}; {report.num_candidates} candidates{hw_note}, "
          f"{report.num_pruned_memory} memory-pruned, "
          f"{report.num_failed} failed) ==")
    print(report.table(top=args.top))
    _print_profile(report)
    _emit_metrics(report, args)
    _emit(report, args.json)
    return 0 if report.runs else 1


def _cmd_plan(args) -> int:
    report = _make_sweep_experiment(args).sweep(**_sweep_call_kwargs(args))
    best = report.best
    if best is None:
        print("no feasible plan found", file=sys.stderr)
        return 1
    p = best.plan
    print(f"best plan for {report.arch} on {report.hardware}:")
    if report.num_hardware > 1:
        print(f"  hardware: {best.hardware}  (co-design over "
              f"{report.num_hardware} variants)")
    print(f"  pp={p.pp} dp={p.dp} tp={p.tp} microbatch={p.microbatch} "
          f"schedule={p.schedule} layout={p.layout}")
    print(f"  -> {best.throughput:.3f} samples/s, bubble {best.bubble_ratio:.1%}, "
          f"peak memory {best.peak_memory_bytes / 1e9:.2f} GB/tile")
    _print_profile(report)
    _emit_metrics(report, args)
    if args.codesign_json is not None:
        spec_dict = report.best_hardware_dict()
        if spec_dict is None:
            print("error: --codesign-json needs a hardware search "
                  "(--hw-* axes)", file=sys.stderr)
            return 2
        from ..core.planner import CodesignResult
        res = CodesignResult(hardware=HardwareSpec.from_dict(spec_dict),
                             plan=p, run=best, report=report)
        text = res.to_json(indent=2)
        if str(args.codesign_json) == "-":
            print(text)
        else:
            args.codesign_json.write_text(text + "\n")
            print(f"[co-design recommendation written to {args.codesign_json}]")
    _emit(best if args.best_only else report, args.json)
    return 0


def _serving_workload(args):
    from ..serving.workload import WorkloadSpec, workload_from_json
    if args.replay is not None:
        return workload_from_json(args.replay.read_text())
    return WorkloadSpec(kind=args.workload, rate=args.rate,
                        num_requests=args.num_requests, seed=args.seed,
                        prompt_mean=args.prompt_mean, prompt_cv=args.prompt_cv,
                        decode_mean=args.decode_mean, decode_cv=args.decode_cv,
                        burst_factor=args.burst_factor,
                        burst_dwell_s=args.burst_dwell_s)


def _cmd_serve_sim(args) -> int:
    from ..serving.system import ServingSpec, simulate_serving
    from ..serving.workload import workload_to_json
    workload = _serving_workload(args)
    spec = ServingSpec(workload=workload,
                       slo_ttft_ms=args.slo_ttft_ms,
                       slo_tpot_ms=args.slo_tpot_ms,
                       max_batch=args.max_batch,
                       kv_budget_bytes=args.kv_budget,
                       policy=args.policy,
                       ctx_bucket=args.ctx_bucket)
    plan = None
    if args.dp != 1 or args.tp != 1 or args.pp != 1:
        plan = ParallelPlan(pp=args.pp, dp=args.dp, tp=args.tp,
                            microbatch=1, global_batch=args.dp,
                            schedule=Schedule.GPIPE, training=False)
    want_trace = args.trace_out is not None or args.trace_npz is not None
    report = simulate_serving(args.arch, _resolve_hardware_args(args), plan,
                              spec, noc_mode=args.noc_mode,
                              boundary_mode=args.boundary_mode,
                              collect_trace=want_trace,
                              metrics=_want_metrics(args))
    print(report.summary())
    if args.workload_out is not None:
        args.workload_out.write_text(
            workload_to_json(workload.generate()) + "\n")
        print(f"[replayable workload trace written to {args.workload_out}]")
    if want_trace:
        trace = report.trace
        if args.trace_out is not None:
            from ..core.trace import chrome_trace
            from ..obs.tracks import serving_counters
            doc = chrome_trace(trace, label=f"{report.arch}@{report.hardware}",
                               counters=serving_counters(report))
            text = json.dumps(doc)
            if str(args.trace_out) == "-":
                print(text)
            else:
                args.trace_out.write_text(text + "\n")
                print(f"[serving trace written to {args.trace_out}: "
                      f"{len(trace)} spans]")
        if args.trace_npz is not None:
            trace.to_npz(args.trace_npz)
            print(f"[columnar trace written to {args.trace_npz}]")
    _emit_metrics(report, args)
    _emit(report, args.json)
    return 0


def _cmd_serve_plan(args) -> int:
    from ..serving.planner import plan_serving
    try:
        mesh, report = plan_serving(
            args.arch, _resolve_hardware_args(args), batch=args.batch,
            context_len=args.context_len, workers=args.workers,
            memory_cap=args.memory_cap)
    except RuntimeError as e:           # infeasibility, with diagnostics
        print(f"error: {e}", file=sys.stderr)
        return 1
    best = report.best
    print(f"best serving split for {report.arch} on {report.hardware}: "
          f"data={mesh['data']} model={mesh['model']} "
          f"({best.throughput:.3f} decode steps/s over "
          f"{report.num_candidates} splits, "
          f"{report.num_pruned_memory} memory-pruned, "
          f"{report.num_failed} failed)")
    _emit(report, args.json)
    return 0


def _load_trace(path: Path):
    """Load a columnar trace: ``.npz`` (``simulate --trace-npz``) or a
    JSON file holding ``Trace.to_dict()`` (or a RunReport dict embedding
    one under ``"trace"``)."""
    from ..core.trace import Trace
    if path.suffix == ".npz":
        try:
            return Trace.from_npz(path)
        except RuntimeError as e:       # numpy-free install
            raise ValueError(str(e))
    doc = json.loads(path.read_text())
    if "traceEvents" in doc:
        raise ValueError(
            f"{path} is a Chrome traceEvents export; trace-diff needs the "
            "columnar form (simulate --trace-npz, or a report with an "
            "embedded trace dict)")
    if "trace" in doc and isinstance(doc["trace"], dict):
        doc = doc["trace"]
    if "stage" not in doc:
        raise ValueError(f"{path} does not contain a columnar trace dict")
    return Trace.from_dict(doc)


def _cmd_trace_diff(args) -> int:
    """Diff two timelines (hardware / plan A/B studies)."""
    from ..core.trace import diff
    d = diff(_load_trace(args.a), _load_trace(args.b))
    print(f"trace diff: {args.a} (A) vs {args.b} (B)")
    print(d.table(top=args.top))
    _emit(d, args.json)
    return 0


def _cmd_metrics(args) -> int:
    """Summarize the repro_torch.obs metrics document embedded in a report JSON
    (``simulate/sweep/plan/serve-sim --json`` run with ``--metrics``), a
    bare metrics document (``--metrics-out``), or — with ``--runs`` — the
    per-run metrics inside a SweepReport."""
    from ..obs.registry import summarize_metrics
    doc = json.loads(args.report.read_text())
    if "metrics" in doc or "runs" in doc:       # a report document
        metrics = doc.get("metrics")
        title = f"{doc.get('arch', '?')} on {doc.get('hardware', '?')}"
    elif "sim" in doc or "host" in doc:         # a bare metrics document
        metrics, title = doc, str(args.report)
    else:
        metrics, title = None, None
    if args.runs:
        shown = 0
        for run in doc.get("runs", []):
            m = run.get("metrics")
            if m is None:
                continue
            plan = run.get("plan", {})
            label = (f"pp={plan.get('pp')} dp={plan.get('dp')} "
                     f"tp={plan.get('tp')} mb={plan.get('microbatch')} "
                     f"on {run.get('hardware', '?')}")
            print(summarize_metrics(m, title=label))
            shown += 1
        if not shown:
            print("error: no per-run metrics in this report; re-run the "
                  "sweep with --metrics", file=sys.stderr)
            return 1
        return 0
    if metrics is None:
        print(f"error: {args.report} carries no metrics document; re-run "
              "with --metrics (or --metrics-out)", file=sys.stderr)
        return 1
    if args.json is not None:
        text = json.dumps(metrics, indent=2)
        if str(args.json) == "-":
            print(text)
        else:
            args.json.write_text(text + "\n")
            print(f"[metrics written to {args.json}]")
        return 0
    print(summarize_metrics(metrics, title=title))
    return 0


def _cmd_hardware(args) -> int:
    """Dump a resolved HardwareSpec as JSON (the --hardware-json schema)."""
    hw = _resolve_hardware_args(args)
    spec = resolve_hardware(hw) if isinstance(hw, str) else hw
    text = spec.to_json(indent=2)
    if args.json is None or str(args.json) == "-":
        print(text)
    else:
        args.json.write_text(text + "\n")
        print(f"[hardware spec written to {args.json}]", file=sys.stderr)
    return 0


def _cmd_fabric(args) -> int:
    """Dump a FabricSpec as JSON (the --fabric-json schema)."""
    from ..fabric import FABRIC_PRESETS, FabricSpec
    if args.fabric_json is not None:
        spec = FabricSpec.from_json(args.fabric_json.read_text())
    else:
        builder = FABRIC_PRESETS.get(args.preset)
        if builder is None:
            raise ValueError(f"unknown fabric preset {args.preset!r}; "
                             f"known: {', '.join(sorted(FABRIC_PRESETS))}")
        spec = builder()
    text = spec.to_json(indent=2)
    if args.json is None or str(args.json) == "-":
        print(text)
    else:
        args.json.write_text(text + "\n")
        print(f"[fabric spec written to {args.json}]", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="PALM performance simulator — typed Experiment front door")
    sub = ap.add_subparsers(dest="command", required=True)

    sim = sub.add_parser("simulate", help="simulate one fixed parallel plan")
    _add_common(sim)
    _add_plan_flags(sim)
    _add_metrics_flags(sim)
    sim.set_defaults(fn=_cmd_simulate)

    swp = sub.add_parser("sweep", help="rank a (hardware x) parallelism search space")
    _add_common(swp)
    _add_sweep_flags(swp)
    _add_metrics_flags(swp)
    swp.set_defaults(fn=_cmd_sweep)

    pln = sub.add_parser("plan", help="print the best plan for an arch/hardware")
    _add_common(pln)
    _add_sweep_flags(pln)
    _add_metrics_flags(pln)
    pln.add_argument("--best-only", action="store_true",
                     help="with --json, write only the best RunReport")
    pln.add_argument("--codesign-json", type=Path, default=None, metavar="FILE",
                     help="with --hw-* axes, write the co-design "
                          "recommendation (winning hardware spec JSON + "
                          "plan) here ('-' for stdout)")
    pln.set_defaults(fn=_cmd_plan)

    ssv = sub.add_parser(
        "serve-sim",
        help="traffic-driven serving simulation (continuous batching, "
             "KV-cache pressure, TTFT/TPOT/goodput SLO metrics)")
    ssv.add_argument("--arch", required=True,
                     help=f"arch-config name (e.g. {', '.join(list_archs()[:3])})")
    _add_hardware(ssv)
    wl = ssv.add_argument_group("workload (seeded request traffic)")
    wl.add_argument("--workload", default="poisson",
                    choices=["poisson", "bursty"],
                    help="arrival process (bursty = 2-state MMPP)")
    wl.add_argument("--rate", type=float, default=4.0,
                    help="offered request rate (req/s)")
    wl.add_argument("--num-requests", type=int, default=64)
    wl.add_argument("--seed", type=int, default=0)
    wl.add_argument("--prompt-mean", type=int, default=512)
    wl.add_argument("--prompt-cv", type=float, default=0.0,
                    help="lognormal coefficient of variation (0 = fixed)")
    wl.add_argument("--decode-mean", type=int, default=64)
    wl.add_argument("--decode-cv", type=float, default=0.0)
    wl.add_argument("--burst-factor", type=float, default=4.0,
                    help="bursty only: burst-state rate multiplier")
    wl.add_argument("--burst-dwell-s", type=float, default=2.0,
                    help="bursty only: mean dwell per MMPP state (s)")
    wl.add_argument("--replay", type=Path, default=None, metavar="FILE",
                    help="replay a recorded workload trace JSON "
                         "(overrides the generator flags)")
    wl.add_argument("--workload-out", type=Path, default=None, metavar="FILE",
                    help="write the generated workload as a replayable "
                         "trace JSON")
    sv = ssv.add_argument_group("serving engine")
    sv.add_argument("--slo-ttft-ms", type=float, default=2000.0,
                    help="time-to-first-token SLO (ms)")
    sv.add_argument("--slo-tpot-ms", type=float, default=200.0,
                    help="time-per-output-token SLO (ms)")
    sv.add_argument("--max-batch", type=int, default=32)
    sv.add_argument("--policy", default="continuous",
                    choices=["continuous", "static"],
                    help="continuous = iteration-level admission; static = "
                         "batches drain fully before the next forms")
    sv.add_argument("--kv-budget", type=float, default=None,
                    help="KV-cache byte budget (default: derived from DRAM "
                         "headroom after weights/activations)")
    sv.add_argument("--ctx-bucket", type=int, default=512,
                    help="context-length rounding for step-cost memoization")
    sv.add_argument("--pp", type=int, default=1)
    sv.add_argument("--dp", type=int, default=1)
    sv.add_argument("--tp", type=int, default=1)
    ssv.add_argument("--noc-mode", type=NoCMode, choices=list(NoCMode),
                     default=NoCMode.MACRO)
    ssv.add_argument("--boundary-mode", type=BoundaryMode,
                     choices=list(BoundaryMode), default=BoundaryMode.PAIRWISE)
    ssv.add_argument("--trace-out", type=Path, default=None, metavar="FILE",
                     help="write the per-request serving timeline as "
                          "Chrome/Perfetto traceEvents JSON ('-' for stdout)")
    ssv.add_argument("--trace-npz", type=Path, default=None, metavar="FILE",
                     help="write the columnar trace as .npz (needs numpy)")
    ssv.add_argument("--json", type=Path, default=None, metavar="FILE",
                     help="write the ServingReport JSON here ('-' for stdout)")
    _add_metrics_flags(ssv)
    ssv.set_defaults(fn=_cmd_serve_sim)

    spl = sub.add_parser(
        "serve-plan",
        help="pick the best (data, model) serving split by simulated "
             "decode throughput")
    spl.add_argument("--arch", required=True,
                     help=f"arch-config name (e.g. {', '.join(list_archs()[:3])})")
    _add_hardware(spl)
    spl.add_argument("--batch", type=int, default=8,
                     help="decode batch the split must serve")
    spl.add_argument("--context-len", type=int, default=4096,
                     help="KV-cache context length for the decode step")
    spl.add_argument("--workers", type=int, default=0,
                     help="0 = serial, N = process pool of N")
    spl.add_argument("--memory-cap", type=float, default=None,
                     help="bytes per tile; infeasible splits are pruned and "
                          "explained (per-split deficits) when nothing fits")
    spl.add_argument("--json", type=Path, default=None, metavar="FILE",
                     help="write the SweepReport JSON here ('-' for stdout)")
    spl.set_defaults(fn=_cmd_serve_plan)

    tdf = sub.add_parser(
        "trace-diff",
        help="diff two simulation timelines (per-stage/per-lane busy & "
             "bubble deltas; A/B hardware studies)")
    tdf.add_argument("a", type=Path, help="baseline trace (.npz or trace-dict JSON)")
    tdf.add_argument("b", type=Path, help="comparison trace (.npz or trace-dict JSON)")
    tdf.add_argument("--top", type=int, default=10,
                     help="NoC/DRAM lanes shown, ranked by |occupancy delta|")
    tdf.add_argument("--json", type=Path, default=None, metavar="FILE",
                     help="write the full diff JSON here ('-' for stdout)")
    tdf.set_defaults(fn=_cmd_trace_diff)

    mtr = sub.add_parser(
        "metrics",
        help="summarize the repro_torch.obs metrics inside a report JSON "
             "(produced by --metrics / --metrics-out)")
    mtr.add_argument("report", type=Path,
                     help="RunReport/SweepReport/ServingReport JSON, or a "
                          "bare metrics document")
    mtr.add_argument("--runs", action="store_true",
                     help="summarize each run's metrics inside a "
                          "SweepReport instead of the sweep roll-up")
    mtr.add_argument("--json", type=Path, default=None, metavar="FILE",
                     help="re-emit the metrics document as JSON ('-' for "
                          "stdout) instead of the text summary")
    mtr.set_defaults(fn=_cmd_metrics)

    hwc = sub.add_parser(
        "hardware",
        help="dump a hardware preset as tweakable --hardware-json JSON")
    _add_hardware(hwc)
    hwc.add_argument("--json", type=Path, default=None, metavar="FILE",
                     help="write the spec here instead of stdout")
    hwc.set_defaults(fn=_cmd_hardware)

    fbc = sub.add_parser(
        "fabric",
        help="dump a fabric preset as tweakable --fabric-json JSON")
    fbc.add_argument("--preset", default="cluster_2x2",
                     help="fabric preset: board_pair, cluster_2x2, "
                          "rack_2x2x2")
    fbc.add_argument("--fabric-json", type=Path, default=None, metavar="FILE",
                     help="round-trip this FabricSpec JSON file instead of "
                          "a preset (validates the schema)")
    fbc.add_argument("--json", type=Path, default=None, metavar="FILE",
                     help="write the spec here instead of stdout")
    fbc.set_defaults(fn=_cmd_fabric)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, KeyError, NotImplementedError) as e:   # not crashes
        print(f"error: {e}", file=sys.stderr)
        return 2
