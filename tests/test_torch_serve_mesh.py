"""The port's serving on a mesh (sharded decode) and its expert-parallel MoE
layer, on 8 gloo CPU processes: against the port's single-device decode,
and, where the mesh changes the semantics (``moe_ep`` sizes each expert's
capacity from a rank's own tokens), against the reference's own mesh run
(tests/torch_mesh_reference.py, 8 host devices).

The workers run this file as a script (``_worker``; tests/torch_mesh_common.py);
this process computes the single-device port and compares.

Decode cases (``DECODE``; tiny archs, the port's init, seed 5, B 4 unless
named): a 2x4 ("data", "model") mesh, B over "data" and the cache span
over "model" (context-parallel attention); a span that does not divide
"model" (14 slots: the KV cache replicated, its rows' updates gathered
over "data"); a 1x8 mesh; B 3, which does not divide "data"; mamba2-2.7b
with 6 SSM heads (d_inner 192), where the state splits hp, not heads (y
gathered, the mixer's tail whole); tiny mamba2-2.7b and hymba-1.5b (8 SSM
heads) on 2x4 and 1x8, where the state splits heads and the mixer is
head parallel (``Block.ssm_tp``: y stays on a rank's heads through the
gated norm and a row-parallel out_proj; on 1x8 one head a rank, and
hymba's 4 attention heads whole); hymba-1.5b 72 steps past its 64-slot
window ring; llava-next-34b from
embeddings; granite-moe and dbrx drop-free (capacity factor 8). Each runs
``make_serve_step`` over fixed inputs; four run ``greedy_generate`` too.

Bounds. fp32: the logits and, after the run, every cache leaf within
1e-5 relative L2 of the single-device port's (the same arithmetic in
another summation order across ranks) and pointwise within 1e-4 of their
largest magnitude (at least 1; the decode tests' 1e-4 against the
reference); greedy tokens equal. Pointwise 1e-5 cannot hold between two
fp32 orders here: the single-device fp32 logits sit up to 1.3e-5 from
fp64 (yi-6b, llava-next-34b), and llava's mesh logits read 2.1e-5 from
them; the reference's init makes k reach ~20 by the second layer, where
the first layer's rounding reads 9e-5. bf16: the rule of the
decode tests (tests/test_torch_models.py): the mesh's logits within half
of the single-device port's own bf16-to-fp32 distance (relative L2) of
its bf16 logits, argmax agreement >= 0.95; MoE archs: no further from the
single-device fp32 logits than 1.25x the single-device bf16 are. The
cache leaves at ``ShardingPlanner.cache``'s placements, each rank holding
its block only.

granite-moe at its default capacity (1.25: C = 1 slot an expert at 2
tokens a "data" rank, where one device has C = 2): greedy tokens equal to
the reference's ``greedy_generate(mesh=)`` and serve-step logits within
1e-4 of its ``make_serve_step(...).jit_with``, on its weights
(``convert.params_from_numpy``). ``moe_ep`` alone (E 10 on a 4-way
"model" axis, padded to 12; T 32, H 16, F 24, top-2, capacity 1.25, so
assignments drop): output within 1e-5 of the reference's ``moe_ep``,
``jax.grad`` of sum(out * cot) in x and every weight within 1e-4,
``load`` and ``drop_fraction`` equal; drop-free (the reference's
test_moe_ep_matches_reference case: T 256, H 32, E 10, F 16, top-4,
capacity 16) within 1e-5 of the port's single-device ``moe``, output and
gradients.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_common import (Clock, init_rank, reference_runs, rel, save,  # noqa: E402
                               spawn_ranks, unflatten)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MESHES = {"2x4": (2, 4), "1x8": (1, 8)}
DROP_FREE = 8.0


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    dtype: str = "float32"
    mesh: str = "2x4"
    max_len: int = 16
    steps: int = 12
    batch: int = 4
    greedy: bool = False
    replace: tuple = ()

    @property
    def tag(self):
        extra = "".join(f"/{k}={v}" for k, v in self.replace)
        return (f"{self.name}/{self.dtype}/{self.mesh}/L{self.max_len}/B{self.batch}"
                f"{extra}")


DECODE = [
    Case("yi-6b", greedy=True),
    Case("yi-6b", max_len=14),
    Case("yi-6b", "bfloat16"),
    Case("yi-6b", mesh="1x8"),
    Case("yi-6b", batch=3),
    Case("mamba2-2.7b", greedy=True),
    Case("mamba2-2.7b", replace=(("d_inner", 192),)),
    Case("mamba2-2.7b", "bfloat16"),
    Case("mamba2-2.7b", mesh="1x8", greedy=True),
    Case("hymba-1.5b", mesh="1x8"),
    Case("hymba-1.5b", max_len=80, steps=72, greedy=True),
    Case("hymba-1.5b", max_len=14),
    Case("hymba-1.5b", "bfloat16", max_len=80, steps=72),
    Case("llava-next-34b"),
    Case("granite-moe-3b-a800m", greedy=True),
    Case("dbrx-132b"),
    Case("granite-moe-3b-a800m", "bfloat16"),
]
# the fp32 single-device runs the bf16 cases are measured against
FP32_OF = {c.tag: dataclasses.replace(c, dtype="float32").tag for c in DECODE
           if c.dtype == "bfloat16"}
# the layer-level moe_ep cases: (T, H, E, F, top_k, capacity factor)
MOE_EP_REF = (32, 16, 10, 24, 2, 1.25)
MOE_EP_DROP_FREE = (256, 32, 10, 16, 4, 16.0)


def _arch(case):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_arch
    return dataclasses.replace(scale_arch(get_config(case.name), "tiny"), **dict(case.replace))


def _run_cfg(arch, dtype, mesh=None, capacity_factor=None):
    from repro_torch.models.lm import RunCfg
    cf = capacity_factor or (DROP_FREE if arch.n_experts else 1.25)
    return RunCfg(compute_dtype=DTYPES[dtype], capacity_factor=cf, mesh=mesh)


def _inputs(arch, case):
    """The fixed inputs [B, steps] (embeddings [B, steps, H] for an
    embeds-input arch) and a greedy prompt [B, 5]."""
    rng = np.random.default_rng(6)
    if arch.embeds_input:
        steps = rng.standard_normal((case.batch, case.steps, arch.d_model)).astype(np.float32)
    else:
        steps = rng.integers(0, arch.vocab, (case.batch, case.steps))
    return steps, rng.integers(0, arch.vocab, (case.batch, 5))


def run_decode(case, mesh=None):
    """The case on ``mesh`` (None: one device): {"logits" [steps, B, V],
    "tokens" (greedy), "cache/<leaf>" whole} and the cache's layout."""
    from repro_torch.models.lm import init_params
    from repro_torch.parallel.comm import is_dtensor
    from repro_torch.serving.serve import greedy_generate, make_serve_step
    arch = _arch(case)
    model = init_params(arch, torch.Generator().manual_seed(5), _run_cfg(arch, case.dtype, mesh),
                        "cpu" if mesh is None else None)
    steps, prompt = _inputs(arch, case)
    cache = model.init_cache(case.batch, case.max_len)
    layout = {n: ([str(p) for p in t.placements], list(t.to_local().shape))
              for n, t in cache.items() if is_dtensor(t)}
    step = make_serve_step(model)
    logits = [step(cache, steps[:, i], i)[1].float().numpy() for i in range(case.steps)]
    out = {"logits": np.stack(logits)}
    for n, t in cache.items():
        out[f"cache/{n}"] = (t.full_tensor() if is_dtensor(t) else t).float().numpy()
    if case.greedy:
        out["tokens"] = greedy_generate(model, prompt, 6).numpy()
    return out, layout


def _moe_ep_inputs(T, H, E, F, k, cf, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, s=0.3: (rng.standard_normal(shape) * s).astype(np.float32)
    return dict(x=f32(T, H, s=1.0), cot=f32(T, H, s=1.0), router=f32(H, E), wg=f32(E, H, F),
                wi=f32(E, H, F), wo=f32(E, F, H), top_k=k, capacity_factor=cf)


def run_moe_ep(inp, mesh):
    """moe_ep on ``mesh`` from whole numpy inputs: out, the gradients of
    sum(out * cot) (whole), load and drop."""
    from repro_torch.models.layers import moe_ep
    from repro_torch.parallel.comm import MeshComm, gather_dim
    from repro_torch.parallel.sharding import MeshPlacements, ShardingPlanner, local_rows
    comm = MeshComm(mesh)
    names = ("router", "wg", "wi", "wo")
    placed = ShardingPlanner(mesh, None).params({f"blocks.0.moe.{n}": inp[n].shape
                                                 for n in names})
    params = {n: MeshPlacements(mesh, placed[f"blocks.0.moe.{n}"])
              .distribute(torch.from_numpy(inp[n])).requires_grad_() for n in names}
    rows = lambda a: local_rows(torch.from_numpy(a), mesh, ("data",))
    x = rows(inp["x"]).requires_grad_()
    out, aux = moe_ep(x, params, int(inp["top_k"]), comm, float(inp["capacity_factor"]))
    (out * rows(inp["cot"])).sum().backward()
    whole = lambda t: gather_dim(t.detach(), 0, mesh.get_group("data")).numpy()
    res = {"out": whole(out), "grad/x": whole(x.grad), "load": aux["load"].numpy(),
           "drop": aux["drop_fraction"].numpy()}
    res.update({f"grad/{n}": p.grad.full_tensor().numpy() for n, p in params.items()})
    return res


# ---------------------------------------------------------------------------
# the worker (a subprocess of this file run as a script; no JAX)
# ---------------------------------------------------------------------------

def _worker(rank: int, tmp: Path) -> None:
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import scale_arch
    from repro_torch.serving.serve import greedy_generate, make_serve_step
    init_rank(rank, tmp)
    meshes = {k: make_mesh(v, ("data", "model"), "cpu") for k, v in MESHES.items()}
    clock, results, arrays = Clock(), {"layout": {}}, {}
    for case in DECODE:
        out, layout = run_decode(case, meshes[case.mesh])
        arrays.update({f"{case.tag}|{k}": v for k, v in out.items()})
        results["layout"][case.tag] = layout
        clock(case.tag)

    # granite-moe at the default capacity, on the reference's weights
    ref = dict(np.load(tmp / "serve.npz"))
    arch = scale_arch(get_config("granite-moe-3b-a800m"), "tiny")
    model = params_from_numpy(unflatten({k[5:]: v for k, v in ref.items()
                                         if k.startswith("tree/")}),
                              arch, _run_cfg(arch, "float32", meshes["2x4"], 1.25))
    from torch_mesh_reference import MAX_NEW, serve_tokens
    prompt, steps = serve_tokens(arch.vocab)
    arrays["granite|tokens"] = greedy_generate(model, prompt, MAX_NEW).numpy()
    cache, step = model.init_cache(*steps.shape), make_serve_step(model)
    arrays["granite|logits"] = np.stack([step(cache, steps[:, i], i)[1].numpy()
                                         for i in range(steps.shape[1])])
    clock("granite default capacity")

    for tag in ("moe_ep", "moe_ep_drop_free"):
        inp = dict(np.load(tmp / f"{tag}_in.npz"))
        arrays.update({f"{tag}|{k}": v for k, v in run_moe_ep(inp, meshes["2x4"]).items()})
        clock(tag)
    save(rank, tmp, results, arrays)


# ---------------------------------------------------------------------------
# the tests (this process: the single-device port; the reference's mesh run)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's mesh runs, then the 8 workers: (results, arrays of
    rank 0, the reference's arrays)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    np.savez(tmp / "moe_ep_in.npz", **_moe_ep_inputs(*MOE_EP_REF, seed=11))
    np.savez(tmp / "moe_ep_drop_free_in.npz", **_moe_ep_inputs(*MOE_EP_DROP_FREE, seed=12))
    ref = reference_runs(tmp, "serve", "moe_ep")
    results, arrays = spawn_ranks(__file__, tmp)
    return results, arrays, ref, tmp


@pytest.fixture(scope="module")
def single():
    """{tag: the single-device run} for every case and fp32 counterpart."""
    cases = {c.tag: c for c in DECODE}
    cases.update({t: dataclasses.replace(cases[b], dtype="float32") for b, t in FP32_OF.items()})
    return {t: run_decode(c)[0] for t, c in cases.items()}


@pytest.mark.parametrize("case", [c for c in DECODE if c.dtype == "float32"],
                         ids=lambda c: c.tag)
def test_sharded_decode_matches_single_device_fp32(ranks, single, case):
    _, arrays, _, _ = ranks
    want = single[case.tag]
    for key, w in want.items():
        got = arrays[f"{case.tag}|{key}"]
        if key == "tokens":
            np.testing.assert_array_equal(got, w)
        else:
            assert rel(got, w) <= 1e-5, (key, rel(got, w))
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 * scale, err_msg=key)


@pytest.mark.parametrize("case", [c for c in DECODE if c.dtype == "bfloat16"],
                         ids=lambda c: c.tag)
def test_sharded_decode_matches_single_device_bf16(ranks, single, case):
    _, arrays, _, _ = ranks
    got = arrays[f"{case.tag}|logits"]
    bf16, fp32 = single[case.tag]["logits"], single[FP32_OF[case.tag]]["logits"]
    noise = rel(bf16, fp32)
    print(f"{case.tag}: mesh to single-device bf16 {rel(got, bf16):.4g}, bf16 noise {noise:.4g}")
    if _arch(case).n_experts:
        assert rel(got, fp32) <= 1.25 * noise
    else:
        assert rel(got, bf16) <= 0.5 * noise
        assert (got.argmax(-1) == bf16.argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("case", DECODE, ids=lambda c: c.tag)
def test_cache_is_stored_at_the_planner_placements(ranks, case):
    """Each leaf at ``ShardingPlanner.cache``'s placements (``cache_pspecs``
    on the mesh's axis sizes), each rank allocating its block only."""
    from repro_torch.parallel.sharding import cache_pspecs, placements_of
    results, arrays, _, _ = ranks
    arch = _arch(case)
    shapes = {n[len(case.tag) + 7:]: a.shape for n, a in arrays.items()
              if n.startswith(f"{case.tag}|cache/")}
    axes = dict(zip(("data", "model"), MESHES[case.mesh]))
    layout = results["layout"][case.tag]
    assert sorted(layout) == sorted(shapes)
    sharded = 0
    for n, spec in cache_pspecs(arch, shapes, axes).items():
        placements, block = layout[n]
        assert placements == [str(p) for p in placements_of(spec, ("data", "model"))], n
        parts = 1
        for dim, entry in enumerate(spec):
            if entry is not None:
                parts *= axes[entry]
                sharded += 1
        assert np.prod(block) * parts == np.prod(shapes[n]), n
    if case.max_len % axes["model"] == 0 and case.batch % axes["data"] == 0:
        assert sharded > 0


def test_granite_moe_default_capacity_matches_the_reference_mesh_run(ranks):
    """At the default capacity the mesh changes the answer (C from a rank's
    own tokens), so the reference's own mesh run is the reference."""
    _, arrays, ref, _ = ranks
    np.testing.assert_array_equal(arrays["granite|tokens"], ref["serve"]["tokens"])
    np.testing.assert_allclose(arrays["granite|logits"], ref["serve"]["logits"], rtol=1e-4,
                               atol=1e-4)


def test_moe_ep_matches_the_reference(ranks):
    _, arrays, ref, _ = ranks
    want = ref["moe_ep"]
    np.testing.assert_allclose(arrays["moe_ep|out"], want["out"], rtol=1e-5, atol=1e-5)
    for n in ("x", "router", "wg", "wi", "wo"):
        np.testing.assert_allclose(arrays[f"moe_ep|grad/{n}"], want[f"grad/{n}"], rtol=1e-4,
                                   atol=1e-4, err_msg=n)
    np.testing.assert_array_equal(arrays["moe_ep|load"], want["load"])
    assert arrays["moe_ep|drop"] == want["drop"] > 0


def test_moe_ep_drop_free_matches_moe(ranks):
    """The reference's test_moe_ep_matches_reference case against the port's
    single-device ``moe``: output and gradients."""
    from repro_torch.models.layers import moe
    _, arrays, _, tmp = ranks
    inp = dict(np.load(tmp / "moe_ep_drop_free_in.npz"))
    x = torch.from_numpy(inp["x"]).requires_grad_()
    params = {n: torch.from_numpy(inp[n]).requires_grad_() for n in ("router", "wg", "wi", "wo")}
    out, aux = moe(x, params, int(inp["top_k"]), float(inp["capacity_factor"]))
    (out * torch.from_numpy(inp["cot"])).sum().backward()
    assert float(aux["drop_fraction"]) == 0.0 == float(arrays["moe_ep_drop_free|drop"])
    np.testing.assert_allclose(arrays["moe_ep_drop_free|out"], out.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    for n, t in {"x": x, **params}.items():
        np.testing.assert_allclose(arrays[f"moe_ep_drop_free|grad/{n}"], t.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), Path(sys.argv[2]))
