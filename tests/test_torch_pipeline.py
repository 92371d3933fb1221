"""The port's int8 gradient compression and GPipe pipeline
(``repro_torch.parallel.compression``, ``repro_torch.parallel.pipeline``)
against ``repro.parallel``'s, run by tests/torch_mesh_reference.py on 8
host devices, and against their plain definitions.

Eight gloo worker processes run this file as a script (``_worker``;
tests/torch_mesh_common.py): ``compressed_psum`` over an 8-rank axis, and
``pipeline_apply`` with S 4 stages on the "pod" axis of a (2, 4) ("data",
"pod") mesh (two pipelines side by side), G 6 microbatches of [2, 16],
stage tanh(x @ w), with the gradient of the sum of its squared outputs.

Bounds: ``compressed_psum`` within 1e-6 of the reference's on the same
inputs (both quantize against the same shared scales; the sum of int8
payloads is exact) and within 1% relative L2 of the exact sum (the
reference's own test); ``quantize_int8`` and two rounds of
``ef_compress_tree`` equal to the reference's bit for bit; the pipeline's
outputs within 1e-6 of the stages applied in turn, its gradients within
1e-5 of autograd through the stages in turn and of ``jax.grad`` through
the reference's pipeline.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_common import (flatten, init_rank, reference_runs, rel, save,  # noqa: E402
                               spawn_ranks)


def _stage(w, x):
    return torch.tanh(x @ w)


def _head(out, labels):
    return ((out - labels) ** 2).mean()


def _labels(mbs):
    return np.random.default_rng(9).standard_normal(mbs.shape).astype(np.float32)


def _worker(rank: int, tmp: Path) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.parallel.pipeline import make_pipeline_loss, pipeline_apply
    init_rank(rank, tmp)
    ref = dict(np.load(tmp / "pipeline.npz"))
    arrays = {}

    pods = make_mesh((8,), ("pod",), "cpu")
    x = torch.from_numpy(ref["psum_in"][rank].copy())
    out = compressed_psum(x, pods.get_group("pod"))
    every = [torch.empty_like(out) for _ in range(8)]
    dist.all_gather(every, out)
    arrays["psum"] = torch.stack(every).numpy()

    mesh = make_mesh((2, 4), ("data", "pod"), "cpu")
    s = mesh.get_local_rank("pod")
    w = torch.from_numpy(ref["w"][s:s + 1].copy()).requires_grad_()
    piped = pipeline_apply(_stage, w, torch.from_numpy(ref["mbs"]), mesh, axis="pod")
    (piped ** 2).sum().backward()
    grads = [torch.empty_like(w.grad) for _ in range(8)]
    dist.all_gather(grads, w.grad)
    arrays["piped"] = piped.detach().numpy()
    arrays["pipe_grad"] = torch.cat(grads).numpy()       # [8, H, H]: rank r's stage r % 4

    w.grad = None
    loss = make_pipeline_loss(_stage, _head, mesh, axis="pod")(
        w, torch.from_numpy(ref["mbs"]), torch.from_numpy(_labels(ref["mbs"])))
    loss.backward()
    dist.all_gather(grads, w.grad)
    arrays["loss"] = loss.detach().numpy()
    arrays["loss_grad"] = torch.cat(grads).numpy()
    save(rank, tmp, {}, arrays)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    ref = reference_runs(tmp, "pipeline")["pipeline"]
    _, arrays = spawn_ranks(__file__, tmp)
    return arrays, ref


def test_compressed_psum_matches_the_reference(ranks):
    arrays, ref = ranks
    got = arrays["psum"]
    for r in range(8):
        np.testing.assert_allclose(got[r], ref["psum"][r], rtol=0, atol=1e-6)
    exact = ref["psum_in"].astype(np.float64).sum(0)
    assert rel(got[0], exact) < 0.01


def test_quantize_and_error_feedback_match_the_reference_bit_for_bit():
    from repro_torch.parallel.compression import dequantize_int8, ef_compress_tree, quantize_int8
    import jax
    from repro.parallel import compression as jcomp
    rng = np.random.default_rng(8)
    g = rng.standard_normal((3, 300)).astype(np.float32)
    c = (rng.standard_normal((2, 700)) * 30).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(g))
    jq, js = jcomp.quantize_int8(g)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_int8(q, s, g.shape, torch.float32).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js, g.shape, np.float32)))
    tree = {"a": torch.from_numpy(g), "b": {"c": torch.from_numpy(c)}}
    jtree = {"a": g, "b": {"c": c}}
    ef = jef = None
    for _ in range(2):
        comp, ef = ef_compress_tree(tree, ef)
        jcompd, jef = jcomp.ef_compress_tree(jtree, jef)
        for got, want in ((comp, jcompd), (ef, jef)):
            fg, fw = flatten(_numpy(got)), flatten(jax.tree.map(np.asarray, want))
            assert sorted(fg) == sorted(fw)
            for k in fw:
                np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def test_pipeline_matches_sequential_stages(ranks):
    arrays, ref = ranks
    w = torch.from_numpy(ref["w"]).requires_grad_()
    y = torch.from_numpy(ref["mbs"])
    for s in range(w.shape[0]):
        y = _stage(w[s], y)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(arrays["piped"], y.detach().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(arrays["piped"], ref["piped"], rtol=0, atol=1e-6)
    got = arrays["pipe_grad"]
    np.testing.assert_array_equal(got[:4], got[4:])          # the two pipelines agree
    np.testing.assert_allclose(got[:4], w.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:4], ref["pipe_grad"], rtol=1e-5, atol=1e-5)


def test_pipeline_loss_matches_sequential_stages(ranks):
    """``make_pipeline_loss``: the mean over microbatches of a loss head on
    the pipeline's outputs, and its gradient in every stage."""
    arrays, ref = ranks
    w = torch.from_numpy(ref["w"]).requires_grad_()
    mbs = torch.from_numpy(ref["mbs"])
    y = mbs
    for s in range(w.shape[0]):
        y = _stage(w[s], y)
    labels = torch.from_numpy(_labels(ref["mbs"]))
    loss = torch.stack([_head(o, t) for o, t in zip(y, labels)]).mean()
    loss.backward()
    np.testing.assert_allclose(arrays["loss"], loss.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(arrays["loss_grad"][:4], w.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(arrays["loss_grad"][:4], arrays["loss_grad"][4:])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), Path(sys.argv[2]))
