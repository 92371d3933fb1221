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

The reference's ``--plan-mesh`` (the mesh picked by ``plan_serving``
through the PALM simulator) has no counterpart: the port neither imports
nor ports the simulator.
"""

import argparse
import dataclasses
import os
import time

import torch


def _mesh(spec: str, device: str):
    """The (data, model) mesh of ``spec`` "D,M" over a process group from
    torchrun's environment (one rank a process)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    data, model = (int(n) for n in spec.split(","))
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return make_serving_mesh({"data": data, "model": model}, device)


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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

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
    mesh = _mesh(args.mesh, device.type) if args.mesh else None
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
