"""The port's batched co-design tier (``repro_torch.core.fastbatch``) and
its kernel's plain version (``kernels.ref.chain_replay_ref``) on the CPU:
``run_fast_batch(device="cpu")`` against the reference's
``repro.core.run_fast_batch`` job by job (every field and the raw trace
bytes, the fallback reasons, the profile's counts), the scalar fast tier
and the event kernel; chain programs of every shape against the scalar
``_ChainEval``; the left fold kept where a reassociating sum would differ;
and no card means a raise, never the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import fastbatch  # noqa: E402
from repro_torch.core.fastpath import _ChainEval  # noqa: E402
from repro_torch.kernels.chain_replay import MAX_DEPTH, chain_replay  # noqa: E402
from repro_torch.kernels.ref import chain_replay_ref  # noqa: E402

from torch_core_common import assert_same_result  # noqa: E402

GB = 1e9
PKGS = (R, T)


def _mesh_hw(pkg, n, flops=4e12, dram_bw=64 * GB, tile_shape=(2, 2), ports=False):
    spec = pkg.MeshSpec(rows=n, cols=n, intra_bw=64 * GB, inter_bw=16 * GB,
                        link_latency=2e-8, tile_shape=tile_shape)
    topo = spec.compile()
    kw = {"dram_ports": (topo.device(0, 0),)} if ports else {}
    return pkg.HardwareSpec(
        name=f"mesh{n}-f{flops:.0e}-d{dram_bw:.0e}", topology=topo,
        tile=pkg.TileSpec(flops=flops, sram_bytes=2e6),
        dram=pkg.DRAMSpec(bandwidth=dram_bw, response_time=3e-7, channels=4), **kw)


def _graph(pkg, layers):
    return pkg.transformer_lm_graph("t", layers, 256, 4, 64, 1, vocab=512)


def _mixed_combos(seed=13):
    """The reference's mixed batch (tests/test_fastbatch.py) as plain
    arguments, without its fabric (tiled_cluster) machines (those are in
    ``_reference_combos``, which keeps its random stream): hardware
    families that share a chain shape, then random singletons over mesh
    sizes, tile shapes, DRAM ports, plans, schedules, recompute, training
    and NoC modes."""
    rng = np.random.default_rng(seed)
    combos = []
    for pp, dp, tp, mb in ((1, 1, 1, 1), (2, 1, 1, 2), (4, 1, 1, 1), (2, 2, 1, 1)):
        plan = dict(pp=pp, dp=dp, tp=tp, microbatch=mb, global_batch=mb * dp * 4,
                    recompute="never", training=bool(rng.random() < 0.7))
        for flops in (2e12, 4e12, 8e12):
            combos.append((dict(n=4, flops=flops), 2, plan, "analytical"))
    for _ in range(12):
        n = int(rng.choice([4, 8]))
        hw = dict(n=n, tile_shape=(2, 2) if rng.random() < 0.5 else (4, 4),
                  ports=bool(rng.random() < 0.5))
        pp, dp, tp = [(1, 1, 1), (2, 1, 1), (2, 1, 2), (2, 2, 1), (4, 1, 1),
                      (1, 2, 2)][rng.integers(6)]
        layers = int(rng.integers(1, 3))
        pp = min(pp, 4 + 2 * layers)        # ops in the graph
        mb = int(rng.choice([1, 2]))
        plan = dict(pp=pp, dp=dp, tp=tp, microbatch=mb,
                    global_batch=mb * dp * int(rng.choice([2, 4])),
                    schedule="1f1b" if rng.random() < 0.7 else "gpipe",
                    recompute=str(rng.choice(["never", "always"])),
                    training=bool(rng.random() < 0.8))
        combos.append((hw, layers, plan, ["analytical", "macro", "detailed"][rng.integers(3)]))
    return combos


def _reference_combos():
    """The reference's mixed batch exactly as its property test draws it
    (``given(n_cases=1, seed=13)``: one stream seeded 130000), its
    tiled_cluster singletons included; the hardware is ``"tiled_cluster"``
    or ``_mesh_hw``'s arguments."""
    rng = np.random.default_rng(13 * 10_000)
    combos = []
    for pp, dp, tp, mb in ((1, 1, 1, 1), (2, 1, 1, 2), (4, 1, 1, 1), (2, 2, 1, 1)):
        plan = dict(pp=pp, dp=dp, tp=tp, microbatch=mb, global_batch=mb * dp * 4,
                    recompute="never", training=bool(rng.random() < 0.7))
        for flops in (2e12, 4e12, 8e12):
            combos.append((dict(n=4, flops=flops), 2, plan, "analytical"))
    for _ in range(12):
        if rng.random() < 0.25:
            hw = "tiled_cluster"
            pp, dp, tp = [(1, 2, 2), (2, 1, 2), (2, 2, 2)][rng.integers(3)]
        else:
            n = int(rng.choice([4, 8]))
            hw = dict(n=n, tile_shape=(2, 2) if rng.random() < 0.5 else (4, 4),
                      ports=bool(rng.random() < 0.5))
            pp, dp, tp = [(1, 1, 1), (2, 1, 1), (2, 1, 2), (2, 2, 1), (4, 1, 1),
                          (1, 2, 2)][rng.integers(6)]
        layers = int(rng.integers(1, 3))
        pp = min(pp, len(_graph(T, layers).ops))
        mb = int(rng.choice([1, 2]))
        plan = dict(pp=pp, dp=dp, tp=tp, microbatch=mb,
                    global_batch=mb * dp * int(rng.choice([2, 4])),
                    schedule="1f1b" if rng.random() < 0.7 else "gpipe",
                    recompute=str(rng.choice(["never", "always"])),
                    training=bool(rng.random() < 0.8))
        combos.append((hw, layers, plan, ["analytical", "macro", "detailed"][rng.integers(3)]))
    return combos


def _sim(pkg, combo, engine="auto", timeline=True):
    hw, layers, plan, mode = combo
    machine = pkg.HARDWARE_PRESETS[hw]() if isinstance(hw, str) else _mesh_hw(pkg, **hw)
    return pkg.PipelineSimulator(
        pkg.map_graph(_graph(pkg, layers), machine, pkg.ParallelPlan(**plan)),
        noc_mode=pkg.NoCMode(mode), engine=engine, collect_timeline=timeline)


def _batch_both(combos, timeline=True, **kw):
    prof_r, prof_t = {}, {}
    a = R.run_fast_batch([_sim(R, c, timeline=timeline) for c in combos], profile=prof_r, **kw)
    b = T.run_fast_batch([_sim(T, c, timeline=timeline) for c in combos], profile=prof_t,
                         device="cpu", **kw)
    return a, b, prof_r, prof_t


COUNTS = ("jobs", "groups", "batched_jobs", "scalar_jobs", "ineligible_jobs", "contended_jobs")


@pytest.mark.parametrize("timeline", [True, False], ids=["timeline", "no_timeline"])
def test_mixed_batch_equals_reference(timeline):
    """Every job: the reference's outcome (result or reason), field by field
    and in its raw trace; the same groups and counts. The timeline run
    validates through the per-config sorts, the other through the
    per-lane ones."""
    combos = _mixed_combos()
    a, b, prof_r, prof_t = _batch_both(combos, timeline)
    hits = 0
    for c, (ra, why_a), (rb, why_b) in zip(combos, a, b):
        assert why_a == why_b, c
        assert (ra is None) == (rb is None), c
        if ra is None:
            continue
        hits += 1
        assert_same_result(ra, rb, c)
        assert R.Trace.from_bytes(rb.trace.to_bytes()) == ra.trace
    assert hits >= 5
    assert {k: prof_r.get(k) for k in COUNTS} == {k: prof_t.get(k) for k in COUNTS}
    assert prof_t["batched_jobs"] >= 12 and prof_t["groups"] < prof_t["batched_jobs"]
    assert prof_t["contended_jobs"] > 0       # the fallback path is exercised


def test_mixed_batch_equals_scalar_and_event_tier():
    """The port's batched results against its own scalar fast tier (raw trace)
    and event kernel (canonical trace), as the reference's test holds its
    own."""
    combos = _mixed_combos()
    batched = T.run_fast_batch([_sim(T, c) for c in combos], device="cpu")
    hits = 0
    for c, (res, reason) in zip(combos, batched):
        sim = _sim(T, c)
        if T.classify_cached(sim) is not None:
            scalar = None
        else:
            scalar, _ = T.replay_chains(sim, T.compile_stage_chains(sim))
        assert (res is None) == (scalar is None), (c, reason)
        if res is None:
            continue
        hits += 1
        assert_same_result(res, scalar, c)
        event = _sim(T, c, engine="event").run()
        for f in ("total_time", "throughput", "noc_bytes", "dram_bytes"):
            assert getattr(res, f) == getattr(event, f), (c, f)
        assert res.trace.canonical() == event.trace.canonical(), c
    assert hits >= 5


@pytest.mark.parametrize("timeline", [True, False], ids=["timeline", "no_timeline"])
def test_reference_batch_with_tiled_cluster_equals_reference(timeline):
    """The reference's own mixed batch, fabric machines included: every
    outcome (result or reason) equal to the reference's, field by field
    and in the raw trace, and the same profile counts."""
    combos = _reference_combos()
    assert sum(c[0] == "tiled_cluster" for c in combos) >= 2
    a, b, prof_r, prof_t = _batch_both(combos, timeline)
    fabric_reasons = set()
    for c, (ra, why_a), (rb, why_b) in zip(combos, a, b):
        assert why_a == why_b, c
        assert (ra is None) == (rb is None), c
        if c[0] == "tiled_cluster":
            fabric_reasons.add(why_b)
        if ra is None:
            continue
        assert_same_result(ra, rb, c)
    assert {k: prof_r.get(k) for k in COUNTS} == {k: prof_t.get(k) for k in COUNTS}
    assert prof_t["jobs"] == len(combos) and prof_t["groups"] < prof_t["batched_jobs"]
    # the stream's fabric jobs are in MACRO and DETAILED modes: each falls
    # back, with the reference's reason
    assert fabric_reasons and None not in fabric_reasons


def test_reference_batch_equals_scalar_and_event_tier():
    """The reference's mixed batch through the port alone: each batched
    result equal to the port's scalar fast tier (raw trace) and its event
    kernel (canonical trace), as the reference's property test holds its
    own; each fallback where the scalar tier falls back."""
    combos = _reference_combos()
    batched = T.run_fast_batch([_sim(T, c) for c in combos], device="cpu")
    hits = 0
    for c, (res, reason) in zip(combos, batched):
        sim = _sim(T, c)
        if T.classify_cached(sim) is not None:
            scalar = None
        else:
            scalar, _ = T.replay_chains(sim, T.compile_stage_chains(sim))
        assert (res is None) == (scalar is None), (c, reason)
        if res is None:
            continue
        hits += 1
        assert_same_result(res, scalar, c)
        event = _sim(T, c, engine="event").run()
        for f in ("total_time", "throughput", "bubble_ratio", "noc_bytes", "dram_bytes"):
            assert getattr(res, f) == getattr(event, f), (c, f)
        assert res.trace.canonical() == event.trace.canonical(), c
    assert hits >= 5


def _tiled_sweep(pkg, timeline):
    """A small co-design sweep in the shape of chip_smoke.py's phase 10: an
    8x8 mesh of 4x4 tiles with DRAM ports every 4th row, two tensor-parallel
    plans, tile and DRAM rates crossed. Its transfers run inside longer
    DRAM holds, so ordering the intervals by end differs from by start."""
    spec = pkg.MeshSpec(rows=8, cols=8, intra_bw=1024 * GB, inter_bw=256 * GB,
                        link_latency=2e-8, tile_shape=(4, 4))
    topo = spec.compile()
    sims = []
    for pp, tp in ((2, 8), (2, 4)):
        plan = pkg.ParallelPlan(pp=pp, tp=tp, microbatch=2, global_batch=8, recompute="never")
        graph = pkg.transformer_lm_graph("t", 4, 512, 8, 256, 2, vocab=2048)
        for flops in (2e12, 8e12):
            for gbs in (16, 256):
                hw = pkg.HardwareSpec(
                    name=f"m8-f{flops:g}-d{gbs}", topology=topo,
                    tile=pkg.TileSpec(flops=flops, sram_bytes=3.75e6),
                    dram=pkg.DRAMSpec(bandwidth=gbs * GB, response_time=3e-7, channels=8),
                    dram_ports=tuple(topo.device(r, 0) for r in range(0, 8, 4)))
                sims.append(pkg.PipelineSimulator(pkg.map_graph(graph, hw, plan),
                                                  collect_timeline=timeline))
    return sims


@pytest.mark.parametrize("timeline", [True, False], ids=["timeline", "no_timeline"])
def test_tiled_sweep_equals_reference(timeline):
    """Every job of the tiled sweep batched, in two groups, each equal to the
    reference's in every field and raw trace; with timelines, the
    resource rows' (end, start, key) order is one a (start, ...) order
    would not give."""
    prof_r, prof_t = {}, {}
    a = R.run_fast_batch(_tiled_sweep(R, timeline), profile=prof_r)
    b = T.run_fast_batch(_tiled_sweep(T, timeline), profile=prof_t, device="cpu")
    assert {k: prof_r.get(k) for k in COUNTS} == {k: prof_t.get(k) for k in COUNTS}
    assert prof_t["groups"] == 2 and prof_t["batched_jobs"] == len(b) == 8
    nested = False
    for (ra, why_a), (rb, why_b) in zip(a, b):
        assert why_a is None and why_b is None
        assert_same_result(ra, rb)
        res = np.asarray(rb.trace.stage) == -1
        starts = np.asarray(rb.trace.start)[res]
        nested |= bool(np.any(starts[1:] < starts[:-1]))
    assert nested == timeline


_MIXED_PLANS = [
    dict(pp=2, dp=1, tp=1, microbatch=2, global_batch=8),
    dict(pp=1, dp=1, tp=1, microbatch=1, global_batch=8),
    # interleave=2 is classifier-ineligible: it falls back mid-batch
    dict(pp=2, dp=1, tp=1, microbatch=1, global_batch=8, interleave=2),
    dict(pp=4, dp=1, tp=1, microbatch=1, global_batch=8),
    dict(pp=2, dp=2, tp=1, microbatch=1, global_batch=8),
]


def _plan_sim(pkg, plan, engine="auto"):
    p = pkg.ParallelPlan(**plan)
    g = pkg.transformer_lm_graph("t", 2, 128, 4, seq_len=64, batch=p.microbatch * p.dp,
                                 vocab=256)
    return pkg.PipelineSimulator(pkg.map_graph(g, _mesh_hw(pkg, 4), p), engine=engine)


def test_fallback_mid_batch_and_strict_fast_engine():
    """A batch mixing fast-eligible and ineligible plans (with one-job
    groups taking the scalar replay): each job's outcome equals the
    reference's, the ineligible plan's reason is the one the strict fast
    engine raises, and the eligible ones equal the event tier."""
    a = R.run_fast_batch([_plan_sim(R, p) for p in _MIXED_PLANS], min_group=1)
    b = T.run_fast_batch([_plan_sim(T, p) for p in _MIXED_PLANS], min_group=1, device="cpu")
    fast = 0
    for plan, (ra, why_a), (rb, why_b) in zip(_MIXED_PLANS, a, b):
        assert why_a == why_b, plan
        assert (ra is None) == (rb is None), plan
        if plan.get("interleave") == 2:
            assert rb is None and "interleaved" in why_b
            for pkg in PKGS:
                with pytest.raises(pkg.FastPathIneligible, match="interleaved"):
                    _plan_sim(pkg, plan, engine="fast").run()
            continue
        event = _plan_sim(T, plan, engine="event").run()
        if rb is None:          # contended: the caller takes the event tier
            assert why_b.startswith("resource contention"), why_b
            continue
        fast += 1
        assert_same_result(ra, rb, plan)
        assert (rb.total_time, rb.throughput) == (event.total_time, event.throughput)
    assert fast >= 1


def test_small_groups_take_the_scalar_replay_as_reference():
    combos = _mixed_combos()[:6]
    a, b, prof_r, prof_t = _batch_both(combos, min_group=4)
    assert prof_t["scalar_jobs"] > 0
    assert {k: prof_r.get(k) for k in COUNTS} == {k: prof_t.get(k) for k in COUNTS}
    for (ra, why_a), (rb, why_b) in zip(a, b):
        assert why_a == why_b
        if ra is not None:
            assert_same_result(ra, rb)


# ---------------------------------------------------------------------------
# chain programs against the scalar evaluator
# ---------------------------------------------------------------------------

def random_chain(shape, values, depth, spine=0):
    """A chain of random structure (``shape``, a numpy Generator) with its
    leaves from ``values`` (an iterator); par/spawn nest at most ``depth``
    deep, and ``spine`` levels of them are forced, nested at the front."""
    chain = []
    if spine:
        kind = "par" if shape.random() < 0.5 else "spawn"
        inner = random_chain(shape, values, depth - 1, spine - 1)
        chain.append(("par", (tuple(inner),)) if kind == "par" else ("spawn", tuple(inner)))
    for _ in range(int(shape.integers(0, 5))):
        r = shape.random()
        if r < 0.3:
            chain.append(("dt", next(values)))
        elif r < 0.55:
            keys = tuple(int(k) for k in shape.integers(0, 1 << 40, int(shape.integers(0, 3))))
            chain.append(("hold", keys, next(values)))
        elif r < 0.75:
            chain.append(("bytes", ["noc", "dram", "fabric"][shape.integers(3)], next(values)))
        elif depth > 0 and r < 0.9:
            chain.append(("par", tuple(tuple(random_chain(shape, values, depth - 1))
                                       for _ in range(int(shape.integers(0, 3))))))
        elif depth > 0:
            chain.append(("spawn", tuple(random_chain(shape, values, depth - 1))))
    return chain


def _values(rng):
    while True:       # magnitudes far apart, so an add's order shows in its bits
        yield float(rng.choice([1.0, 1e-3, 1e8, 3e15])) * float(rng.random())


def _scalar(chain, t):
    ev = _ChainEval()
    end = ev.run(chain, t)
    return end, ev


@pytest.mark.parametrize("depth,G", [(1, 1), (3, 5), (6, 31), (MAX_DEPTH, 3)])
def test_chain_programs_equal_scalar_evaluator(depth, G):
    """G chains of one random shape (nesting to ``depth``) with their own
    leaves: the program's end times, holds, spawns and byte counters equal
    ``_ChainEval``'s, config by config."""
    chains = [random_chain(np.random.default_rng(depth), _values(np.random.default_rng(g)),
                           depth, spine=depth) for g in range(G)]
    compiled = [fastbatch.compile_chain(ch) for ch in chains]
    code, prog, _ = compiled[0]
    assert prog.depth == depth
    V = torch.tensor(np.array([c[2] for c in compiled]).T.reshape(-1, G), dtype=torch.float64)
    t0 = torch.tensor(np.random.default_rng(99).random(G) * 1e3, dtype=torch.float64)
    accs = torch.tensor(np.random.default_rng(98).random((3, G)), dtype=torch.float64)
    accs0 = accs.clone()
    t, hs, he, sp = chain_replay(torch.from_numpy(code), V.contiguous(), t0, accs,
                                 entry=prog.entry, holds=len(prog.keys), spawns=prog.spawns,
                                 depth=prog.depth)
    for g, chain in enumerate(chains):
        end, ev = _scalar(chain, float(t0[g]))
        assert t[g].item() == end
        assert list(prog.keys) == ev.keys
        assert hs[:, g].tolist() == ev.starts and he[:, g].tolist() == ev.ends
        assert sp[:, g].tolist() == ev.spawned
        # each counter is its seed plus the chain's byte leaves, in walk order
        for a, name in enumerate(("noc", "dram", "fabric")):
            assert accs[a, g].item() == _refold(chain, name, accs0[a, g].item()), (g, name)


def _refold(chain, acc, seed):
    """``seed`` plus ``chain``'s byte leaves of ``acc``, in walk order."""
    for node in chain:
        if node[0] == "bytes" and (node[1] == acc or (acc == "fabric"
                                                       and node[1] not in ("noc", "dram"))):
            seed += node[2]
        elif node[0] == "par":
            for b in node[1]:
                seed = _refold(b, acc, seed)
        elif node[0] == "spawn":
            seed = _refold(node[1], acc, seed)
    return seed


def test_chain_program_from_zero_equals_scalar_counters():
    chain = random_chain(np.random.default_rng(7), _values(np.random.default_rng(8)), 4, 4)
    code, prog, leaves = fastbatch.compile_chain(chain)
    accs = torch.zeros(3, 1, dtype=torch.float64)
    chain_replay(torch.from_numpy(code), torch.tensor(leaves, dtype=torch.float64)[:, None],
                 torch.zeros(1, dtype=torch.float64), accs, entry=prog.entry,
                 holds=len(prog.keys), spawns=prog.spawns, depth=prog.depth)
    _, ev = _scalar(chain, 0.0)
    assert accs[:, 0].tolist() == [ev.noc_bytes, ev.dram_bytes, ev.fabric_bytes]


def test_segment_fold_is_left_to_right():
    """Leaves [1e16, 1, -1e16, 1]: the left fold gives 1.0; a pairwise sum
    gives 0.0. The plain version keeps the fold (what torch.cumsum gives
    on this host is reported, not relied on)."""
    leaves = [1e16, 1.0, -1e16, 1.0]
    code, prog, _ = fastbatch.compile_chain([("dt", x) for x in leaves])
    V = torch.tensor(leaves, dtype=torch.float64)[:, None]
    t, *_ = chain_replay_ref(torch.from_numpy(code), V, torch.zeros(1, dtype=torch.float64),
                             torch.zeros(3, 1, dtype=torch.float64), prog.entry, 0, 0, 0)
    seq = 0.0
    for x in leaves:
        seq += x
    pairwise = (leaves[0] + leaves[1]) + (leaves[2] + leaves[3])
    assert seq == 1.0 and pairwise == 0.0
    assert t.item() == seq
    cumsum = torch.cumsum(V[:, 0], 0)[-1].item()
    print(f"torch.cumsum on the CPU gives {cumsum!r}, the left fold {seq!r}")


def test_chain_replay_refuses_what_the_kernel_does_not_take():
    code, prog, leaves = fastbatch.compile_chain([("dt", 1.0)])
    V = torch.tensor(leaves, dtype=torch.float64)[:, None]
    args = (torch.from_numpy(code), V, torch.zeros(1, dtype=torch.float64),
            torch.zeros(3, 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="stack"):
        chain_replay(*args, entry=0, holds=0, spawns=0, depth=MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="fp64"):
        chain_replay(args[0], V.float(), *args[2:], entry=0, holds=0, spawns=0, depth=0)
    with pytest.raises(ValueError, match="int32"):
        chain_replay(args[0].long(), *args[1:], entry=0, holds=0, spawns=0, depth=0)
    with pytest.raises(ValueError, match="entry"):
        chain_replay(*args, entry=len(code), holds=0, spawns=0, depth=0)
    deep = random_chain(np.random.default_rng(0), _values(np.random.default_rng(0)),
                        MAX_DEPTH + 1, MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="deep"):
        fastbatch.compile_chain(deep)


def test_no_card_raises_and_cpu_launches_nothing(monkeypatch):
    """``device=None`` means the card: without one it raises, never falls
    back to the CPU. On the CPU nothing is launched."""
    kernels.reset_launch_counts()
    combos = _mixed_combos()[:3]
    T.run_fast_batch([_sim(T, c) for c in combos], device="cpu")
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_fast_batch([_sim(T, c) for c in combos])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_fast_batch([], device="cuda")


def test_group_program_covers_the_leaf_matrix():
    """The group compiler reads every leaf row exactly once per program
    set, and its depth and counts are those of the chains."""
    sim = _sim(T, _mixed_combos()[3])
    chains = T.compile_stage_chains(sim)
    sig, leaves = fastbatch._signature(sim, chains)
    progs, rows, code = fastbatch._compile_group(sig[5])
    assert rows == len(leaves)
    assert code.dtype == np.int32 and code[-1] == fastbatch._END
    for slot, chs in zip(progs, chains):
        for prog, ch in zip(slot, chs):
            assert (prog is None) == (ch is None)
            if prog is not None:
                _, ev = _scalar(ch, 0.0)
                assert prog.nodes == ev.nodes and list(prog.keys) == ev.keys
                assert prog.spawns == len(ev.spawned)
