"""Decoder LM of the port: the dense path of ``repro.models.lm``
(``block="attn"``, no experts, token inputs).

The reference keeps layer-stacked leaves ([L, ...]) scanned by
``lax.scan``; here each layer is a ``Block`` in an ``nn.ModuleList`` and
the scan is a loop. ``repro_torch.convert`` maps between the two.

Weights are held in ``cfg.compute_dtype``: they are cast once when the
model is built, where the reference casts them on every call
(``forward`` casts every stacked leaf, ``decode_step`` every per-layer
slice but the 1-D norms, which ``layers.rmsnorm`` then casts to the
activation type). Both give the same weights to the arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from .layers import attention, decode_attention, mlp, rmsnorm, rope

__all__ = ["RunCfg", "LM", "Block", "init_params", "param_count"]


@dataclass(frozen=True)
class RunCfg:
    """Mirrors ``repro.models.lm.RunCfg`` with torch dtypes. The mesh fields
    arrive with distribution; ``q_chunk`` has no counterpart (the flash
    kernel is tiled); remat, scan and the SSM/MoE knobs arrive with the
    slices that use them, and ``param_dtype`` with training's master
    weights. Logits are always fp32 (the reference's default
    ``logits_fp32=True``, which no caller changes)."""

    compute_dtype: torch.dtype = torch.bfloat16


def _check_supported(arch: ArchConfig) -> None:
    if arch.block != "attn":
        raise NotImplementedError(
            f"{arch.name}: block={arch.block!r} is not ported yet "
            "(ROADMAP.md, queue 1: SSM and hybrid)")
    if arch.n_experts:
        raise NotImplementedError(f"{arch.name}: MoE is not ported yet (ROADMAP.md, queue 1: MoE)")
    if arch.embeds_input:
        raise NotImplementedError(
            f"{arch.name}: embeds-input archs are not ported yet "
            "(ROADMAP.md, queue 1: encoder and embeds-input archs)")


def _empty(device, dtype, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


class Block(nn.Module):
    """One pre-norm transformer layer: attention, then the MLP."""

    def __init__(self, arch: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        self.arch = arch
        H, nh, nkv, hd, F = arch.d_model, arch.n_heads, arch.n_kv, arch.head_dim, arch.d_ff
        e = lambda *shape: _empty(device, dtype, *shape)
        self.norm1 = e(H)
        self.attn = nn.ParameterDict({"wq": e(H, nh * hd), "wk": e(H, nkv * hd),
                                      "wv": e(H, nkv * hd), "wo": e(nh * hd, H)})
        if F:
            self.norm2 = e(H)
            mlp_p = {"wi": e(H, F), "wo": e(F, H)}
            if arch.mlp == "gated_silu":
                mlp_p["wg"] = e(H, F)
            self.mlp = nn.ParameterDict(mlp_p)

    def _qkv(self, h: torch.Tensor, positions: torch.Tensor):
        a = self.arch
        B, S, _ = h.shape
        q = (h @ self.attn["wq"]).reshape(B, S, a.n_heads, a.head_dim)
        k = (h @ self.attn["wk"]).reshape(B, S, a.n_kv, a.head_dim)
        v = (h @ self.attn["wv"]).reshape(B, S, a.n_kv, a.head_dim)
        return rope(q, positions), rope(k, positions), v

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        if not self.arch.d_ff:
            return x
        return x + mlp(rmsnorm(x, self.norm2), self.mlp, self.arch.mlp)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        q, k, v = self._qkv(rmsnorm(x, self.norm1), positions)
        o = attention(q, k, v, causal=self.arch.causal, window=self.arch.window)
        x = x + o.reshape(B, S, -1) @ self.attn["wo"]
        return self._ffn(x)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: int) -> torch.Tensor:
        """One token: x [B,1,H]; writes this token's k, v into the layer's
        cache [B,span,nkv,hd] in place (the reference returns a new cache)."""
        B = x.shape[0]
        posb = torch.full((B, 1), pos, device=x.device)
        q, k, v = self._qkv(rmsnorm(x, self.norm1), posb)
        span = k_cache.shape[1]
        slot = pos % span if self.arch.window else pos
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
        o = decode_attention(q, k_cache, v_cache, min(pos + 1, span))
        x = x + o.reshape(B, 1, -1) @ self.attn["wo"]
        return self._ffn(x)


class LM(nn.Module):
    """Token-input decoder: embed, ``num_layers`` blocks, final norm, head."""

    def __init__(self, arch: ArchConfig, cfg: RunCfg = RunCfg(), device=None):
        super().__init__()
        _check_supported(arch)
        device = resolve_device(device)
        self.arch, self.cfg = arch, cfg
        dt, H, V = cfg.compute_dtype, arch.d_model, arch.vocab
        self.embed = _empty(device, dt, V, H)
        self.blocks = nn.ModuleList(Block(arch, dt, device) for _ in range(arch.num_layers))
        self.final_norm = _empty(device, dt, H)
        self.lm_head = _empty(device, dt, H, V)

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    def forward(self, tokens: torch.Tensor, logits_positions: str = "all") -> torch.Tensor:
        """tokens [B,S] -> fp32 logits [B,S,V], or [B,1,V] with
        ``logits_positions="last"`` (prefill: no [B,S,V] buffer)."""
        x = self.embed[tokens]
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        for blk in self.blocks:
            x = blk(x, positions)
        if logits_positions == "last":
            x = x[:, -1:]
        logits = rmsnorm(x, self.final_norm) @ self.lm_head
        return logits.float()

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """KV cache [L,B,span,nkv,hd]; window archs keep a ring buffer of
        ``window`` positions."""
        a = self.arch
        span = min(a.window, max_len) if a.window else max_len
        shape = (a.num_layers, batch, span, a.n_kv, a.head_dim)
        z = lambda: torch.zeros(shape, dtype=self.cfg.compute_dtype, device=self.device)
        return {"k": z(), "v": z()}

    def decode_step(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    pos: int) -> torch.Tensor:
        """One autoregressive step at position ``pos``: tokens [B] -> fp32
        logits [B,V]. ``cache`` is updated in place."""
        x = self.embed[tokens][:, None]
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, cache["k"][i], cache["v"][i], pos)
        logits = rmsnorm(x, self.final_norm) @ self.lm_head
        return logits[:, 0].float()


def _dense(gen: torch.Generator, shape, scale: float, cfg: RunCfg, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale
    return w.to(cfg.compute_dtype)


@torch.no_grad()
def init_params(arch: ArchConfig, generator: torch.Generator, cfg: RunCfg = RunCfg(),
                device=None) -> LM:
    """A model with random weights drawn from ``generator`` (which must live
    on ``device``), with the shapes and scales of ``repro.models.lm.init_params``.

    The reference's ``_dense`` takes fan-in from the first dim of the
    layer-stacked leaf, which is L: wq, wk, wv, wi and wg have std
    (1/L)^0.5. That is kept, so both packages draw from one distribution."""
    model = LM(arch, cfg, device)
    dev = model.device
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the model on {dev}")
    L = arch.num_layers
    stacked = (1.0 / L) ** 0.5
    out_attn = (1.0 / (arch.n_heads * arch.head_dim)) ** 0.5 / (2 * L) ** 0.5
    out_mlp = (1.0 / arch.d_ff) ** 0.5 / (2 * L) ** 0.5 if arch.d_ff else 0.0
    for blk in model.blocks:
        blk.norm1.fill_(1.0)
        for name in ("wq", "wk", "wv"):
            blk.attn[name].copy_(_dense(generator, blk.attn[name].shape, stacked, cfg, dev))
        blk.attn["wo"].copy_(_dense(generator, blk.attn["wo"].shape, out_attn, cfg, dev))
        if arch.d_ff:
            blk.norm2.fill_(1.0)
            for name, p in blk.mlp.items():
                scale = out_mlp if name == "wo" else stacked
                p.copy_(_dense(generator, p.shape, scale, cfg, dev))
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(_dense(generator, model.lm_head.shape, 0.02, cfg, dev))
    model.embed.copy_(_dense(generator, model.embed.shape, 0.02, cfg, dev))
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
