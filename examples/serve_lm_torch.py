"""Batched serving with the PyTorch/CUDA port (``repro_torch``), the
counterpart of ``examples/serve_lm.py``: greedy generation
(``repro_torch.serving.greedy_generate``: the prompt through the decode
step with its KV or SSM cache, then new tokens) on a reduced architecture;
reports tokens/s. On the card by default:

    PYTHONPATH=src python examples/serve_lm_torch.py --arch yi-6b
    PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-2.7b --device cpu

``--layers N`` serves the first N layers at the scale's widths: a model
larger than one card at full width, such as nemotron-4-340b (18.9 GB of
embed and head, 6.9 GB a layer in bf16), on one 80 GB card:

    PYTHONPATH=src python examples/serve_lm_torch.py --arch nemotron-4-340b --scale full --layers 8

``--mesh D,M`` serves on a (data, model) mesh of D x M ranks
(``launch.mesh.make_serving_mesh``: the batch over "data", the KV span and
the SSM heads over "model", the weights gathered a layer at a time), one
process a rank under ``torchrun``, NCCL on the card, gloo on the CPU:

    PYTHONPATH=src torchrun --nproc-per-node 2 examples/serve_lm_torch.py --mesh 1,2

With ``--plan-mesh`` the example closes the paper's §V-B loop for
serving: ``repro_torch.serving.plan_serving`` sweeps decode-step splits
through the PALM simulator (host code) for ``--hardware``, and generation
runs on the suggested ``(data, model)`` mesh, as ``--mesh`` would. The
split covers every device of the simulated hardware, so torchrun must
start that many processes (the reference forces that many host devices
instead); another world size is an error, never a smaller split:

    PYTHONPATH=src torchrun --nproc-per-node 4 examples/serve_lm_torch.py \
        --plan-mesh --hardware tpu_v5e_2x2
"""

import argparse
import dataclasses
import os
import time

import torch


def _mesh(mesh_axes, device: str):
    """The ``{"data": D, "model": M}`` mesh over a process group from
    torchrun's environment (one rank a process)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return make_serving_mesh(mesh_axes, device)


def _planned_mesh_axes(arch, args):
    """``plan_serving``'s ``{"data": dp, "model": tp}`` for ``--hardware``,
    which must have as many devices as torchrun started processes."""
    from repro_torch.api import resolve_hardware
    from repro_torch.serving import plan_serving
    devices = resolve_hardware(args.hardware).num_devices
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != devices:
        raise SystemExit(f"--plan-mesh: {args.hardware} has {devices} devices but this run has "
                         f"{world} processes; start it with torchrun --nproc-per-node "
                         f"{devices}")
    mesh_axes, report = plan_serving(arch, hardware=args.hardware, batch=args.batch,
                                     context_len=args.prompt_len + args.new_tokens)
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"plan_serving on {args.hardware}: mesh {mesh_axes} "
              f"({report.best.throughput:.1f} simulated decode steps/s, "
              f"{report.num_candidates} splits ranked)")
    return mesh_axes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--scale", default="small", choices=["tiny", "small", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers (default: all of the scale's)")
    ap.add_argument("--mesh", default=None, help="D,M: serve on a (data, model) mesh "
                                                 "(under torchrun with D*M processes)")
    ap.add_argument("--plan-mesh", action="store_true",
                    help="pick the (data, model) mesh with plan_serving and serve on it "
                         "(under torchrun with --hardware's device count of processes)")
    ap.add_argument("--hardware", default="tpu_v5e_2x2",
                    help="hardware preset plan_serving simulates (--plan-mesh only)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.plan_mesh and args.mesh:
        ap.error("--plan-mesh picks the mesh; it does not go with --mesh")

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_arch
    from repro_torch.models.lm import RunCfg, init_params
    from repro_torch.parallel.sharding import mesh_device
    from repro_torch.serving.serve import greedy_generate

    arch = scale_arch(get_config(args.arch), args.scale)
    if args.layers:
        arch = dataclasses.replace(arch, num_layers=args.layers)
    if arch.embeds_input:
        raise SystemExit(f"{arch.name} takes precomputed embeddings; use an LM arch for this "
                         f"example")
    device = resolve_device(args.device)
    mesh_axes = None
    if args.plan_mesh:
        mesh_axes = _planned_mesh_axes(arch, args)
    elif args.mesh:
        mesh_axes = dict(zip(("data", "model"), (int(n) for n in args.mesh.split(","))))
    mesh = _mesh(mesh_axes, device.type) if mesh_axes else None
    where = device if mesh is None else mesh_device(mesh)
    model = init_params(arch, torch.Generator(device=where).manual_seed(0),
                        RunCfg(remat=False, mesh=mesh), device)
    prompts = torch.randint(0, arch.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    out = greedy_generate(model, prompts, args.new_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rank = 0 if mesh is None else torch.distributed.get_rank()
    if rank == 0:
        ranks = "" if mesh is None else f" on a {tuple(mesh.shape)} mesh"
        print(f"{arch.name} (L={arch.num_layers}): generated {tuple(out.shape)} in {dt:.2f}s "
              f"({args.batch * args.new_tokens / dt:.1f} tok/s on {device.type}{ranks}, "
              f"batch={args.batch})")
        print("first sequence:", out[0][:16].tolist())
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
