"""Serve step, prefill and greedy generation, with the semantics of
``repro.serving.serve``. The model carries its arch and run config; every
entry point runs under ``torch.inference_mode()`` on the model's device.
The decode cache is updated in place.

Every entry point also runs a model built on a mesh (the reference's
``jit_with`` shardings; the caller builds the mesh, e.g.
``launch.mesh.make_serving_mesh``): every rank passes the whole batch and
gets the whole outputs back. Prefill runs this rank's rows over the batch
axes, decode over "data" (the cache's batch axis, ``cache_pspecs``), each
replicated where B does not divide; the outputs are gathered over those
axes. Decode keeps the cache context parallel over "model" and streams
the weights a layer at a time (``models.lm.LM.decode_step``)."""

from __future__ import annotations

import torch

from ..models.lm import LM
from ..obs.registry import span
from ..parallel.comm import gather_dim
from ..parallel.sharding import FSDP, local_rows

__all__ = ["make_serve_step", "make_prefill_step", "greedy_generate"]


def make_serve_step(model: LM):
    """One greedy decode step: (cache, tokens [B], pos) ->
    (next_tokens [B] int32, logits [B,V], cache). For an embeds-input arch
    the input is embeds [B,H] in place of tokens (the reference's
    ``serve_step``). ``cache`` is ``model.init_cache``'s; ``pos`` a Python
    int."""
    mesh = model.cfg.mesh

    @torch.inference_mode()
    def serve_step(cache, tokens, pos: int):
        whole = torch.as_tensor(tokens, device=model.device)
        x = whole if mesh is None else local_rows(whole, mesh, (FSDP,))
        if model.arch.embeds_input:
            logits = model.decode_step(cache, None, pos, embeds=x)
        else:
            logits = model.decode_step(cache, x, pos)
        if x.shape[0] != whole.shape[0]:
            logits = gather_dim(logits, 0, mesh.get_group(FSDP))
        return logits.argmax(dim=-1).to(torch.int32), logits, cache

    return serve_step


def make_prefill_step(model: LM):
    """Batched prefill: (batch with ``tokens`` [B,S], or ``embeds`` [B,S,H]
    for an embeds-input arch) -> logits, only the last position's
    ([B,1,V]) for causal archs, every position's ([B,S,V]) for encoders.
    For a model built on a mesh, every rank passes the whole batch and
    gets the whole logits back: each rank runs its rows (the batch over
    (pod?, data), replicated where B does not divide) and the logits are
    gathered over the batch axes."""
    positions = "last" if model.arch.causal else "all"
    key = "embeds" if model.arch.embeds_input else "tokens"

    @torch.inference_mode()
    def prefill(batch):
        with span("host.serve.prefill"):      # to the logits' enqueue, no sync
            whole = torch.as_tensor(batch[key], device=model.device)
            mesh = model.cfg.mesh
            x = whole if mesh is None else local_rows(whole, mesh, model.comm.batch_axes)
            logits = model(logits_positions=positions, **{key: x})
            if x.shape[0] == whole.shape[0]:          # one device, or a replicated batch
                return logits
            for d in reversed(model.comm.batch_dims):  # minor axis first
                logits = gather_dim(logits, 0, mesh.get_group(d))
            return logits

    return prefill


@torch.inference_mode()
def greedy_generate(model: LM, prompt_tokens, max_new: int) -> torch.Tensor:
    """Prefill the prompt token by token through the decode step, then
    decode ``max_new`` tokens greedily. Returns [B, max_new] int32. Token
    archs only, as the reference's. A model on a mesh decodes through the
    sharded serve step (the reference's ``greedy_generate(mesh=)``)."""
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    prompt = torch.as_tensor(prompt_tokens, device=model.device)
    B, S0 = prompt.shape
    cache = model.init_cache(B, S0 + max_new)
    step = make_serve_step(model)
    tok = prompt[:, 0]
    out = []
    for i in range(S0 + max_new - 1):
        nxt, _, cache = step(cache, tok, i)
        if i + 1 < S0:
            tok = prompt[:, i + 1]
        else:
            tok = nxt
            out.append(tok)
    return torch.stack(out, dim=1)
