"""The port's dry-run (``repro_torch.launch.dryrun``) and what it is built
from, against the reference where there is one: the launch presets and
the input specs against ``repro.launch``'s for every arch and shape; the
per-device train state (master weights and optimizer state) the dry-run
builds on the production meshes against the sum of the reference's shard
sizes (its ``param_pspecs`` on an ``AbstractMesh``); the collective
counter on a hand-built c10d sequence (the reference's HLO parser test,
``tests/test_system.py``); each kernel op's fake implementation against
its CPU implementation (shapes, dtypes, strides); the dry-run's flops
against ``FlopCounterMode``'s; one full-scale cell end to end, and the
nemotron-4-340b cell that reaches flash at head dim 192; ``--palm-trace
--trace-only`` against the reference's trace files. Cells on a "fake"
process group run in subprocesses, so no process group outlives its
test, and so does the reference's dry-run (importing it sets
``XLA_FLAGS``)."""

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import input_specs as jspecs  # noqa: E402
from repro.launch import presets as jpresets  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, input_specs, presets  # noqa: E402
from repro_torch.launch.comm_analysis import CollectiveCounter  # noqa: E402
from repro_torch.launch.train import scale_arch  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

# the kernel modules (``repro_torch.kernels`` exports functions of the same names)
kflash = importlib.import_module("repro_torch.kernels.flash_attention")
krms = importlib.import_module("repro_torch.kernels.rmsnorm")
kssd = importlib.import_module("repro_torch.kernels.ssd_scan")

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(jax_configs.ARCHS)
# RunCfg fields of the reference the port has no counterpart of (models/lm.py's RunCfg)
DROPPED = {"q_chunk", "ssd_chunk", "scan_layers", "batch_axes", "expert_axis", "logits_fp32"}


def _dtype_name(d) -> str:
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return jnp.dtype(d).name


def _env():
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}


# --------------------------------------------------------------------- presets

def _check_run_cfg(got, want):
    fields = {f.name for f in dataclasses.fields(want)}
    mine = {f.name for f in dataclasses.fields(got)}
    assert fields - mine == DROPPED                     # every other field is the port's too
    for name in fields & mine - {"mesh"}:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, torch.dtype):
            assert _dtype_name(a) == _dtype_name(b), name
        else:
            assert a == b, name


@pytest.mark.parametrize("name", ARCHS)
def test_presets_equal_reference(name):
    """``run_cfg_for`` and ``train_cfg_for`` (on 16 and 32 data-parallel
    rows) for every shape: every field equal to the reference's, dtypes by
    name; the reference's ``q_chunk``, ``ssd_chunk``, ``scan_layers`` and
    the mesh-set fields are the ones dropped."""
    arch, jarch = get_config(name), jax_configs.get_config(name)
    for sname, shape in SHAPES.items():
        jshape = jax_configs.SHAPES[sname]
        _check_run_cfg(presets.run_cfg_for(arch, shape), jpresets.run_cfg_for(jarch, jshape))
        for dp in (16, 32):
            got, want = presets.train_cfg_for(arch, shape, dp), jpresets.train_cfg_for(
                jarch, jshape, dp)
            _check_run_cfg(got.run, want.run)
            assert got.num_microbatches == want.num_microbatches == \
                presets.microbatches_for(arch, shape, dp)
            assert _dtype_name(got.grad_accum_dtype) == _dtype_name(want.grad_accum_dtype)
            assert dataclasses.asdict(got.opt) == {
                **dataclasses.asdict(want.opt), "moment_dtype": got.opt.moment_dtype}
            assert _dtype_name(got.opt.moment_dtype) == _dtype_name(want.opt.moment_dtype)


# ----------------------------------------------------------------- input specs

def _leaves(tree):
    return {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in tree.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_equal_reference(name):
    """Train and prefill specs for every shape of the kind; decode's cache
    leaf by leaf against ``jax.eval_shape`` of the reference's
    ``init_cache`` (through its ``decode_input_specs``), its token input,
    and ``pos`` the last slot."""
    arch, jarch = get_config(name), jax_configs.get_config(name)
    for sname, shape in SHAPES.items():
        jshape = jax_configs.SHAPES[sname]
        if shape.kind == "train":
            G = presets.microbatches_for(arch, shape, 16)
            got = input_specs.train_input_specs(arch, shape, G)
            assert _leaves(got) == _leaves(jspecs.train_input_specs(jarch, jshape, G))
            assert all(t.is_meta for t in got.values())
        elif shape.kind == "prefill":
            assert _leaves(input_specs.prefill_input_specs(arch, shape)) == \
                _leaves(jspecs.prefill_input_specs(jarch, jshape))
        elif jax_configs.shape_applicable(jarch, jshape)[0]:
            run = presets.run_cfg_for(arch, shape)
            cache, tokens, pos = input_specs.decode_input_specs(LM(arch, run, "meta"), shape)
            jcache, jtokens, _ = jspecs.decode_input_specs(jarch, jshape,
                                                           jpresets.run_cfg_for(jarch, jshape))
            assert _leaves(cache) == _leaves(jcache)
            assert (tuple(tokens.shape), _dtype_name(tokens.dtype)) == \
                (tuple(jtokens.shape), _dtype_name(jtokens.dtype))
            assert pos == shape.seq_len - 1


# ------------------------------------------------- per-device train state bytes

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

_STATE_CHILD = """
import json, torch
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.presets import train_cfg_for
from repro_torch.train.step import init_train_state
multi = {multi}
dryrun.fake_world(512 if multi else 256)
mesh = make_production_mesh(multi_pod=multi, device_type="meta")
out = {{}}
for name in sorted(ARCHS):
    arch = get_config(name)
    cfg = train_cfg_for(arch, SHAPES["train_4k"], 32 if multi else 16)
    state = init_train_state(arch, cfg, torch.Generator(), "meta", mesh=mesh)
    out[name] = dryrun.train_argument_bytes(state, {{}})
    if arch.block in ("ssm", "hymba"):
        out["ssm_tp|" + name] = sorted({{blk.ssm_tp for blk in state.model.blocks}})
print(json.dumps(out))
"""


def _reference_state_bytes(name, mesh):
    """Bytes of one device's shards of the reference's train state at
    ``train_cfg_for``: fp32 master weights by ``param_pspecs`` on an
    ``AbstractMesh``, and Adam's m and v (mirroring them) plus its int32
    step."""
    shape, names = MESHES[mesh]
    jmesh, axes = AbstractMesh(shape, names), dict(zip(names, shape))
    arch = jax_configs.get_config(name)
    cfg = jpresets.train_cfg_for(arch, jax_configs.SHAPES["train_4k"], 32 if "pod" in names else 16)
    params = jax.eval_shape(lambda: jlm.init_params(arch, jax.random.PRNGKey(0), cfg.run))
    specs = jsharding.param_pspecs(params, jmesh)
    local = 0
    for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (leaf.ndim - len(spec))):
            names = (entry,) if isinstance(entry, str) else entry or ()
            parts = math.prod(axes[a] for a in names)
            assert dim % parts == 0
            n *= dim // parts
        local += n
    moment = jnp.dtype(cfg.opt.moment_dtype).itemsize
    return {"params": 4 * local, "opt_state": 2 * moment * local + 4}


@pytest.fixture(scope="module")
def state_bytes():
    """{mesh: {arch: the dry-run's argument bytes}}, one child a mesh, run
    side by side."""
    procs = {mesh: subprocess.Popen([sys.executable, "-W", "ignore", "-c",
                                     _STATE_CHILD.format(multi=mesh == "2x16x16")],
                                    env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for mesh in MESHES}
    out = {}
    for mesh, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-4000:]
        out[mesh] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("name,mesh", [(n, m) for n in ARCHS for m in MESHES])
def test_train_state_bytes_equal_reference_shards(state_bytes, name, mesh):
    got = state_bytes[mesh][name]
    want = _reference_state_bytes(name, mesh)
    assert (got["params"], got["opt_state"]) == (want["params"], want["opt_state"])


@pytest.mark.parametrize("mesh", MESHES)
def test_ssm_mixer_is_head_parallel_at_full_width(state_bytes, mesh):
    """On the 16-way model axis of both production meshes mamba2-2.7b's 80
    SSM heads divide it, so its mixer is head parallel (``Block.ssm_tp``)
    in every layer; hymba-1.5b's 50 do not, so its mixer is computed
    whole."""
    got = state_bytes[mesh]
    assert got["ssm_tp|mamba2-2.7b"] == [True]
    assert got["ssm_tp|hymba-1.5b"] == [False]


# ------------------------------------------------------------------ collectives

@pytest.fixture
def fake_group():
    import torch.distributed as dist
    dryrun.fake_world(256)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        yield init_device_mesh("meta", (16, 16), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_collective_counter_bytes(fake_group):
    """The bytes each device receives, per kind, on a c10d sequence over a
    fake 256-rank group (the shapes of the reference's parser test): an
    all-gather into [256, 32] fp32 over 16 ranks; all-reduces of [4, 128,
    128] fp32 and [16] bf16; a reduce-scatter onto [8, 64] fp32; an
    all-to-all of [2, 2, 128, 128] fp32."""
    import torch.distributed as dist
    data, model = fake_group.get_group(0), fake_group.get_group(1)
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    with CollectiveCounter() as c:
        dist.all_gather_into_tensor(m(256, 32), m(16, 32), group=data)
        dist.all_reduce(m(4, 128, 128), group=model)
        dist.all_reduce(m(16, dtype=torch.bfloat16), group=model)
        dist.reduce_scatter_tensor(m(8, 64), m(128, 64), group=model)
        dist.all_to_all_single(m(2, 2, 128, 128), m(2, 2, 128, 128), group=model)
    assert c.bytes["all-gather"] == 256 * 32 * 4
    assert c.bytes["all-reduce"] == 4 * 128 * 128 * 4 + 16 * 2
    assert c.bytes["reduce-scatter"] == 8 * 64 * 4
    assert c.bytes["all-to-all"] == 2 * 2 * 128 * 128 * 4
    assert c.bytes["collective-permute"] == 0
    assert c.bytes["total"] == sum(v for k, v in c.bytes.items() if k != "total")
    assert c.calls == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1, "all-to-all": 1,
                       "collective-permute": 0, "total": 5}


# -------------------------------------------------------- fake vs CPU kernel ops

def _cpu_and_meta(*ts):
    """The CPU tensors and meta tensors of the same shapes, strides and
    storage offsets."""
    meta = []
    for t in ts:
        if t is None:
            meta.append(None)
            continue
        base = torch.empty(t.untyped_storage().nbytes() // t.element_size(), dtype=t.dtype,
                           device="meta")
        meta.append(base.as_strided(t.shape, t.stride(), t.storage_offset()))
    return list(ts), meta


def _layouts(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [(tuple(t.shape), t.dtype, t.stride()) for t in out]


def _same(op, *args, **kwargs):
    tensors = [a for a in args if isinstance(a, torch.Tensor) or a is None]
    n = len(tensors)
    cpu, meta = _cpu_and_meta(*tensors)
    got_cpu = op(*cpu, *args[n:], **kwargs)
    got_meta = op(*meta, *args[n:], **kwargs)
    assert _layouts(got_meta) == _layouts(got_cpu)
    assert all(t.is_meta for t in (got_meta if isinstance(got_meta, tuple) else (got_meta,)))


def _rand(*shape, dtype=torch.bfloat16, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype,T,H", [(torch.bfloat16, 6, 512), (torch.bfloat16, 3, 2560),
                                       (torch.float32, 5, 64)])
def test_rmsnorm_ops_fake_match_cpu(dtype, T, H):
    x, w, dy = _rand(T, H, dtype=dtype), _rand(H, dtype=dtype, seed=1), _rand(T, H, dtype=dtype)
    _same(torch.ops.repro_torch.rmsnorm, x, w, 1e-5)
    _same(torch.ops.repro_torch.rmsnorm_bwd, x, w, dy, 1e-5)


@pytest.mark.parametrize("dtype,hd,views,causal,window", [
    (torch.bfloat16, 64, False, True, 0), (torch.bfloat16, 128, True, True, 0),
    (torch.bfloat16, 80, True, False, 0), (torch.bfloat16, 64, True, True, 16),
    (torch.float32, 32, False, True, 0)])
def test_flash_ops_fake_match_cpu(dtype, hd, views, causal, window):
    """Forward with and without the LSE (o in q's layout, the LSE in the
    kernels' padded rows), backward (dq, dk, dv in their inputs' layouts);
    the model's [B,S,nh,hd] views too."""
    B, S, nh, nkv = 2, 40, 4, 2
    if views:
        q = _rand(B, S, nh, hd, dtype=dtype).transpose(1, 2)
        k, v = (_rand(B, S, nkv, hd, dtype=dtype, seed=s).transpose(1, 2) for s in (1, 2))
    else:
        q = _rand(B, nh, S, hd, dtype=dtype)
        k, v = (_rand(B, nkv, S, hd, dtype=dtype, seed=s) for s in (1, 2))
    for lse in (True, False):
        _same(torch.ops.repro_torch.flash_attention_fwd, q, k, v, causal, window, lse, 0.0)
    o, lse = kflash.flash_attention_fwd(q, k, v, causal=causal, window=window)
    do = torch.empty_like(q).copy_(_rand(*q.shape, dtype=dtype, seed=3))
    _same(torch.ops.repro_torch.flash_attention_bwd, q, k, v, o, do, lse, causal, window, 0,
          0.0)


@pytest.mark.parametrize("dtype,hp,N,views,state", [
    (torch.bfloat16, 64, 64, False, False), (torch.bfloat16, 64, 128, True, True),
    (torch.bfloat16, 64, 16, False, True), (torch.float32, 16, 16, False, False),
    (torch.bfloat16, 32, 64, True, False)])
def test_ssd_ops_fake_match_cpu(dtype, hp, N, views, state):
    """Both paths (wgmma: bf16 hp 64; FMA: the rest), with the state
    options where the wgmma path serves them; the model's views."""
    B, nh, S = 1, 3, 70
    if views:
        x = _rand(B, S, nh, hp, dtype=dtype).transpose(1, 2)
        dt = torch.rand(B, S, nh).transpose(1, 2) * 0.1
    else:
        x, dt = _rand(B, nh, S, hp, dtype=dtype), torch.rand(B, nh, S) * 0.1
    A = -torch.rand(nh) - 0.5
    Bm, Cm = _rand(B, S, N, dtype=dtype, seed=1), _rand(B, S, N, dtype=dtype, seed=2)
    init = torch.zeros(B, nh, hp, N) if state else None
    _same(torch.ops.repro_torch.ssd_scan, x, dt, A, Bm, Cm, init, 256, state)
    dy = torch.empty_like(x).copy_(_rand(*x.shape, dtype=dtype, seed=3))
    _same(torch.ops.repro_torch.ssd_scan_bwd, x, dt, A, Bm, Cm, dy, init,
          torch.zeros(B, nh, hp, N) if state else None, 256)


def test_fake_ops_refuse_what_the_card_refuses():
    """A fake run raises where the CUDA path would: a head dim no kernel
    has (224), an SSD state width no kernel has, a misaligned view (a
    storage offset of 2 bytes)."""
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        kflash.flash_attention(meta(1, 96, 16, 224), meta(1, 8, 16, 224), meta(1, 8, 16, 224))
    x = meta(1, 2, 40, 64)
    with pytest.raises(ValueError, match="instantiated"):
        kssd.ssd_scan(x, meta(1, 2, 40, dtype=torch.float32), meta(2, dtype=torch.float32),
                      meta(1, 40, 48), meta(1, 40, 48))
    with pytest.raises(ValueError, match="aligned"):
        krms.rmsnorm(meta(4 * 256 + 1)[1:].view(4, 256), meta(256))


# --------------------------------------------------------- flops and the meter

@pytest.mark.parametrize("name", ["yi-6b", "mamba2-2.7b"])
def test_meter_flops_equal_flop_counter_mode(name):
    """The dry-run's flops are ``FlopCounterMode``'s: a tiny train step and
    a prefill on the meta device, each under both (the kernel ops through
    their formulas, flash's and the SSD scan's both ways)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.lm import RunCfg, init_params
    from repro_torch.serving.serve import make_prefill_step
    from repro_torch.train.step import TrainCfg, init_train_state, make_train_step
    arch = scale_arch(get_config(name), "tiny")
    cfg = TrainCfg(run=RunCfg(remat=False), num_microbatches=2)
    batch = lambda: {k: torch.zeros(2, 2, 64, dtype=torch.int32, device="meta")
                     for k in ("tokens", "labels")}
    state = lambda: init_train_state(arch, cfg, torch.Generator(), "meta")
    step = lambda a: make_train_step(arch, cfg)(*a)
    got = dryrun.measure(lambda: (state(), batch()), step)
    with FlopCounterMode(display=False) as fc:
        step((state(), batch()))
    assert got["flops"] == fc.get_total_flops() > 0
    model = lambda: init_params(arch, torch.Generator(), RunCfg(), "meta")
    prefill = lambda a: make_prefill_step(a[0])({"tokens": a[1]})
    tokens = lambda: torch.zeros(2, 64, dtype=torch.int32, device="meta")
    got = dryrun.measure(lambda: (model(), tokens()), prefill)
    with FlopCounterMode(display=False) as fc:
        prefill((model(), tokens()))
    assert got["flops"] == fc.get_total_flops() > 0


def test_meter_counts_kernel_scratch():
    """A kernel op's scratch counts while it runs: the wgmma SSD backward's
    fp32 scratch (``bwd_scratch_bytes``) lifts the peak above its inputs
    and outputs, and everything is freed after."""
    B, nh, S, hp, N = 1, 80, 2048, 64, 128
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")

    def args():
        return (meta(B, nh, S, hp), meta(B, nh, S, dtype=torch.float32),
                meta(nh, dtype=torch.float32), meta(B, S, N), meta(B, S, N), meta(B, nh, S, hp))

    got = dryrun.measure(args, lambda a: kssd.ssd_scan_bwd(*a))
    seg, group = kssd.bwd_plan(B, nh, S, 132, N)
    outputs = (2 * B * nh * S * hp + 4 * B * nh * S + 4 * nh + 2 * 2 * B * S * N
               + 4 * B * nh * hp * N)
    scratch = kssd.bwd_scratch_bytes(B, nh, S, N, seg, group)
    assert got["peak_bytes"] - got["live_bytes_at_start"] >= outputs + scratch
    assert got["peak_bytes"] - got["live_bytes_at_start"] <= outputs + scratch + 16 * 512


# ------------------------------------------------------------------ whole cells

def test_one_full_scale_cell(tmp_path):
    """yi-6b decode_32k on the 16x16 pod through the CLI: a record with the
    peak, the argument bytes, flops, the collectives by kind and ``fits``."""
    r = subprocess.run([sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
                        "--arch", "yi-6b", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(tmp_path)], env=_env(), cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads((tmp_path / "yi-6b__decode_32k__single.json").read_text())
    assert rec["ok"] and rec["fits"] and rec["chips"] == 256
    arch = get_config("yi-6b")
    # the cache: k and v [L, B, S, nkv, hd] bf16, B over "data", the span over "model"
    cache = 2 * arch.num_layers * (128 // 16) * (32768 // 16) * arch.n_kv * arch.head_dim * 2
    assert rec["memory"]["argument_bytes"]["cache"] == cache
    assert rec["memory"]["peak_bytes"] > cache
    assert rec["flops"] > 0 and rec["collectives"]["calls"]["total"] > 0
    assert rec["collectives"]["bytes"]["total"] == sum(
        v for k, v in rec["collectives"]["bytes"].items() if k != "total")
    assert rec["target"]["total_memory"] > rec["memory"]["peak_bytes"]
    assert rec["model_flops"] == dryrun.model_flops(arch, SHAPES["decode_32k"])


def test_nemotron_prefill_fails_on_head_dim_192(tmp_path):
    """nemotron-4-340b's prefill_32k on the 16x16 pod reaches flash at head
    dim 192 (the name is from before hd 192 had a kernel, when this cell
    stopped on the kernel's check): the cell records ok, its flash calls
    planned by the hd-192 instantiation's fake implementation, with a peak
    under the card's memory (20.62 GiB a device; ~7 s on a CPU)."""
    r = subprocess.run([sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
                        "--arch", "nemotron-4-340b", "--shape", "prefill_32k", "--mesh", "single",
                        "--out", str(tmp_path)], env=_env(), cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads((tmp_path / "nemotron-4-340b__prefill_32k__single.json").read_text())
    assert rec["ok"] and rec["fits"] and rec["chips"] == 256
    assert 0 < rec["memory"]["peak_bytes"] < rec["target"]["total_memory"]
    assert rec["flops"] > 0 and rec["collectives"]["calls"]["total"] > 0


PALM_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
PALM_ARGS = ["--arch", "yi-6b", "--palm-trace", "--trace-only", "--palm-hardware", "tpu_v5e_2x2"]


@pytest.fixture(scope="module")
def reference_palm_traces(tmp_path_factory):
    """The reference's ``--palm-trace --trace-only`` files for yi-6b at
    PALM_SHAPES on ``tpu_v5e_2x2``, written by one subprocess."""
    out = tmp_path_factory.mktemp("palm_ref")
    calls = "; ".join(f"main({PALM_ARGS + ['--shape', s, '--out', str(out)]!r})"
                      for s in PALM_SHAPES)
    r = subprocess.run([sys.executable, "-W", "ignore", "-c",
                        f"from repro.launch.dryrun import main; {calls}"],
                       env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return out, r.stdout.splitlines()


@pytest.mark.parametrize("shape", PALM_SHAPES)
def test_palm_trace_equals_reference(shape, reference_palm_traces, tmp_path, capsys):
    """``--palm-trace --trace-only`` writes the reference's
    ``<arch>__<shape>.palm_trace.json``, key for key and byte for byte,
    prints its line and stops before the cell's step (no record)."""
    ref_dir, ref_lines = reference_palm_traces
    assert dryrun.main([*PALM_ARGS, "--shape", shape, "--out", str(tmp_path)]) == 0
    name = f"yi-6b__{shape}.palm_trace.json"
    port, ref = (d / name for d in (tmp_path, ref_dir))
    assert json.loads(port.read_text()) == json.loads(ref.read_text())
    assert port.read_text() == ref.read_text()
    line = capsys.readouterr().out.strip()
    assert line == next(x for x in ref_lines if name in x).replace(str(ref_dir), str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [name]
    rec = json.loads(port.read_text())
    assert rec["hardware"] == "tpu_v5e_2x2" and rec["trace"]["traceEvents"]
    assert rec["plan"]["training"] == (shape == "train_4k")


def test_trace_only_needs_palm_trace(tmp_path, capsys):
    with pytest.raises(SystemExit) as err:
        dryrun.main(["--arch", "yi-6b", "--shape", "train_4k", "--trace-only",
                     "--out", str(tmp_path)])
    assert err.value.code == 2 and "add --palm-trace" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


# --------------------------------------------------- chip_smoke.py's bounds

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _old_pairs(S, causal=True, window=0):
    if not causal:
        return S * S
    return sum(min(i + 1, window) if window else i + 1 for i in range(S))


@pytest.mark.parametrize("case,window,causal", [
    ((2, 2000, 32, 4, 128), 0, True), ((2, 2000, 25, 5, 64), 1024, True),
    ((2, 2000, 24, 8, 64), 0, True), ((2, 2000, 16, 16, 80), 0, False),
    ((2, 2000, 56, 8, 128), 0, True), ((1, 2048, 32, 4, 128), 0, True),
    ((1, 2048, 25, 5, 64), 1024, True), ((1, 2048, 16, 16, 80), 0, False)])
def test_flash_bounds_unchanged(case, window, causal):
    """chip_smoke.py's flash bounds take their products from the package's
    formulas, equal to the count they computed before (PERF.md §6's
    shapes)."""
    cs = _chip_smoke()
    B, S, nh, nkv, hd = case
    q = torch.empty(B, nh, S, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, nkv, S, hd, dtype=torch.bfloat16, device="meta")
    pairs = _old_pairs(S, causal, window)
    assert kflash.pairs(S, causal, window) == pairs
    (_, _), fwd = cs.flash_fwd_bound(q, k, causal, window)
    (_, _), bwd = cs.flash_bwd_bound(q, k, causal, window)
    assert fwd == 4 * B * nh * hd * pairs
    assert bwd == 5 * 2 * B * nh * hd * pairs


def _ssd_inputs(B, nh, S, hp, N):
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    return (meta(B, nh, S, hp), meta(B, nh, S, dtype=torch.float32), meta(nh, dtype=torch.float32),
            meta(B, S, N), meta(B, S, N))


@pytest.mark.parametrize("case", [(2, 80, 2000, 64, 128), (2, 50, 2000, 64, 16),
                                  (1, 80, 2048, 64, 128), (1, 50, 2048, 64, 16)])
def test_ssd_bounds_unchanged(case):
    cs = _chip_smoke()
    B, nh, S, hp, N = case
    Q = kssd.KERNEL_CHUNK
    assert kssd.fwd_flops(B, nh, S, hp, N) == B * S * (2 * Q * N + nh * (2 * Q * hp + 4 * hp * N))
    pairs = sum(n * (n + 1) // 2 for n in [Q] * (S // Q) + [S % Q])
    assert kssd.bwd_flops(B, nh, S, hp, N) == (
        B * pairs * 2 * N + B * nh * (pairs * 2 * (2 * hp + 2 * N) + S * 5 * 2 * hp * N))
    x = _ssd_inputs(*case)
    assert cs.ssd_fwd_bound(*x, Q)[0] > 0 and cs.ssd_bwd_bound(*x, torch.bfloat16)[0] > 0


def test_recorded_bounds_do_not_move():
    """PERF.md §6's first rows: flash 0.0663 ms, its backward 0.0869, the
    SSD forward 0.0254 and backward 0.0198 (4 decimals)."""
    cs = _chip_smoke()
    bf = torch.bfloat16
    q = torch.empty(2, 32, 2000, 128, dtype=bf, device="meta")
    k = torch.empty(2, 4, 2000, 128, dtype=bf, device="meta")
    assert round(cs.flash_fwd_bound(q, k)[0][0], 4) == 0.0663
    q = torch.empty(1, 32, 2048, 128, dtype=bf, device="meta")
    k = torch.empty(1, 4, 2048, 128, dtype=bf, device="meta")
    assert round(cs.flash_bwd_bound(q, k)[0][0], 4) == 0.0869
    assert round(cs.ssd_fwd_bound(*_ssd_inputs(2, 80, 2000, 64, 128), kssd.KERNEL_CHUNK)[0], 4) \
        == 0.0254
    assert round(cs.ssd_bwd_bound(*_ssd_inputs(1, 80, 2048, 64, 128), bf)[0], 4) == 0.0198
