"""Decoder LM of the port: the dense and SSM paths of ``repro.models.lm``
(``block="attn"`` and ``block="ssm"``, no experts, token inputs).

The reference keeps layer-stacked leaves ([L, ...]) scanned by
``lax.scan``; here each layer is a ``Block`` in an ``nn.ModuleList`` and
the scan is a loop. ``repro_torch.convert`` maps between the two.

Weights are held in ``cfg.compute_dtype``: they are cast once when the
model is built, where the reference casts them on every call
(``forward`` casts every stacked leaf, ``decode_step`` every per-layer
slice but the 1-D norms, which ``layers.rmsnorm`` then casts to the
activation type). Both give the same weights to the arithmetic.

Training (``repro_torch.train.step``) keeps fp32 master weights
(``RunCfg.param_dtype``) beside these compute-dtype weights and copies them
in after every optimizer step: the same arithmetic as the reference, which
keeps ``param_dtype`` parameters and casts them on every forward.

Four SSM leaves are the exception: ``conv_b``, ``A_log``, ``D`` and
``dt_bias`` are fp32 in the reference's parameters, and its two casts
treat them differently. ``forward`` casts every stacked leaf with ndim > 1
to the compute dtype, and these are [L, .], so prefill uses them rounded
to it; ``decode_step`` casts per-layer slices, where they are 1-D, so
decode uses them in fp32. The port keeps the four in fp32 and reproduces
both: ``Block._ssm`` rounds them to the compute dtype, ``Block._ssm_decode``
does not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from .layers import (attention, decode_attention, mlp, rmsnorm, rope, silu, softplus, ssd_scan,
                     ssm_decode_step)

__all__ = ["RunCfg", "LM", "Block", "init_params", "loss_fn", "param_count"]


@dataclass(frozen=True)
class RunCfg:
    """Mirrors ``repro.models.lm.RunCfg`` with torch dtypes. The mesh fields
    arrive with distribution; ``q_chunk`` has no counterpart (the flash
    kernel is tiled), nor ``ssd_chunk``: no caller changes its 256, the
    plain SSD version's default chunk (the SSD kernel blocks by its own);
    ``scan_layers`` has none (the layers are a loop) and the MoE knobs
    arrive with MoE. ``param_dtype`` is the type of training's master
    weights. ``remat`` recomputes each ``Block`` in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
    layer body); it acts only where autograd records. Logits are always
    fp32 (the reference's default ``logits_fp32=True``, which no caller
    changes)."""

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True


def _check_supported(arch: ArchConfig) -> None:
    if arch.block not in ("attn", "ssm"):
        raise NotImplementedError(
            f"{arch.name}: block={arch.block!r} is not ported yet "
            "(ROADMAP.md, queue 1: hybrid)")
    if arch.n_experts:
        raise NotImplementedError(f"{arch.name}: MoE is not ported yet (ROADMAP.md, queue 1: MoE)")
    if arch.embeds_input:
        raise NotImplementedError(
            f"{arch.name}: embeds-input archs are not ported yet "
            "(ROADMAP.md, queue 1: encoder and embeds-input archs)")


def _empty(device, dtype, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


class Block(nn.Module):
    """One pre-norm layer: attention then the MLP (``block="attn"``), or
    the Mamba2 mixer alone (``block="ssm"``, ``d_ff=0``)."""

    def __init__(self, arch: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        self.arch = arch
        H, nh, nkv, hd, F = arch.d_model, arch.n_heads, arch.n_kv, arch.head_dim, arch.d_ff
        e = lambda *shape: _empty(device, dtype, *shape)
        self.norm1 = e(H)
        if arch.has_attention:
            self.attn = nn.ParameterDict({"wq": e(H, nh * hd), "wk": e(H, nkv * hd),
                                          "wv": e(H, nkv * hd), "wo": e(nh * hd, H)})
        if arch.block == "ssm":
            di, N, K = arch.d_inner, arch.ssm_state, arch.conv_width
            f32 = lambda *shape: _empty(device, torch.float32, *shape)
            self.ssm = nn.ParameterDict({
                "in_proj": e(H, 2 * di + 2 * N + arch.ssm_n_heads),
                "conv_w": e(K, di + 2 * N), "conv_b": f32(di + 2 * N),
                "A_log": f32(arch.ssm_n_heads), "D": f32(arch.ssm_n_heads),
                "dt_bias": f32(arch.ssm_n_heads), "ssm_norm": e(di), "out_proj": e(di, H)})
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

    def _split(self, proj: torch.Tensor):
        """in_proj's output -> z [.,di], xbc [.,conv_dim], dt's input [.,nh]."""
        a = self.arch
        return proj.split([a.d_inner, a.d_inner + 2 * a.ssm_state, a.ssm_n_heads], dim=-1)

    def _ssm(self, h: torch.Tensor) -> torch.Tensor:
        """``lm._run_ssm`` (prefill): h [B,S,H] -> [B,S,H]. The causal
        depthwise conv is the reference's K shifted multiply-adds in the
        activation type (not ``F.conv1d``: that keeps its rounding, and
        keeps cuDNN's TF32 off the fp32 path); the fp32 leaves are rounded
        to the compute dtype, as the reference's ``forward`` casts them."""
        a, p = self.arch, self.ssm
        B, S, _ = h.shape
        di, N, nh, hp, K = a.d_inner, a.ssm_state, a.ssm_n_heads, a.ssm_headdim, a.conv_width
        cdt = h.dtype
        z, xbc, dtr = self._split(h @ p["in_proj"])
        padded = F.pad(xbc, (0, 0, K - 1, 0))
        conv = sum(padded[:, k:k + S] * p["conv_w"][k] for k in range(K)) + p["conv_b"].to(cdt)
        xs, Bm, Cm = silu(conv).split([di, N, N], dim=-1)
        dt = softplus(dtr.float() + p["dt_bias"].to(cdt).float())
        A = -torch.exp(p["A_log"].to(cdt))
        x4 = xs.reshape(B, S, nh, hp)
        y = ssd_scan(x4, dt, A, Bm, Cm)
        y = y + p["D"].to(cdt)[:, None] * x4
        y = rmsnorm(y.reshape(B, S, di) * silu(z), p["ssm_norm"])
        return y @ p["out_proj"]

    def _ssm_decode(self, h: torch.Tensor, conv_cache: torch.Tensor,
                    ssm_cache: torch.Tensor) -> torch.Tensor:
        """``lm._decode_ssm``: h [B,1,H] -> [B,1,H]. Updates the layer's
        conv cache [B,K-1,conv_dim] and SSM state [B,nh,hp,N] in place. The
        fp32 leaves stay fp32, as in the reference's decode, so the conv
        sum and its SiLU run in fp32 before the cast."""
        a, p = self.arch, self.ssm
        B = h.shape[0]
        di, N, nh, hp = a.d_inner, a.ssm_state, a.ssm_n_heads, a.ssm_headdim
        z, xbc, dtr = self._split((h @ p["in_proj"])[:, 0])
        hist = torch.cat([conv_cache, xbc[:, None]], dim=1)          # [B,K,conv_dim]
        conv = (hist * p["conv_w"]).sum(dim=1) + p["conv_b"]
        conv_cache.copy_(hist[:, 1:])
        xs, Bm, Cm = silu(conv).to(h.dtype).split([di, N, N], dim=-1)
        dt = softplus(dtr.float() + p["dt_bias"])
        A = -torch.exp(p["A_log"])
        x3 = xs.reshape(B, nh, hp)
        y, new_state = ssm_decode_step(x3, dt, A, Bm, Cm, ssm_cache)
        ssm_cache.copy_(new_state)
        y = y + p["D"].to(y.dtype)[:, None] * x3
        y = rmsnorm(y.reshape(B, 1, di) * silu(z)[:, None], p["ssm_norm"])
        return y @ p["out_proj"]

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x, self.norm1)
        if self.arch.block == "ssm":
            return self._ffn(x + self._ssm(h))
        B, S, _ = x.shape
        q, k, v = self._qkv(h, positions)
        o = attention(q, k, v, causal=self.arch.causal, window=self.arch.window)
        x = x + o.reshape(B, S, -1) @ self.attn["wo"]
        return self._ffn(x)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
        """One token: x [B,1,H]; ``cache`` holds this layer's slices of the
        model's cache, updated in place (the reference returns a new
        cache): k, v [B,span,nkv,hd] get this token's k, v; conv and ssm
        get the new conv window and SSM state."""
        h = rmsnorm(x, self.norm1)
        if self.arch.block == "ssm":
            return self._ffn(x + self._ssm_decode(h, cache["conv"], cache["ssm"]))
        B = x.shape[0]
        posb = torch.full((B, 1), pos, device=x.device)
        q, k, v = self._qkv(h, posb)
        k_cache, v_cache = cache["k"], cache["v"]
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
        """tokens [B,S] -> fp32 logits [B,S,V] (fp64 for an fp64 model), or
        [B,1,V] with ``logits_positions="last"`` (prefill: no [B,S,V]
        buffer)."""
        x = self.embed[tokens]
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, x, positions, use_reentrant=False) if remat else blk(x, positions)
        if logits_positions == "last":
            x = x[:, -1:]
        logits = rmsnorm(x, self.final_norm) @ self.lm_head
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Attention archs: KV cache k, v [L,B,span,nkv,hd] in the compute
        dtype; window archs keep a ring buffer of ``window`` positions. SSM
        archs: the conv window [L,B,K-1,conv_dim] in the compute dtype and
        the state [L,B,nh,hp,N] in fp32, whatever ``max_len``."""
        a, L, dt = self.arch, self.arch.num_layers, self.cfg.compute_dtype
        z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=self.device)
        cache = {}
        if a.has_attention:
            span = min(a.window, max_len) if a.window else max_len
            cache["k"] = z((L, batch, span, a.n_kv, a.head_dim), dt)
            cache["v"] = z((L, batch, span, a.n_kv, a.head_dim), dt)
        if a.block == "ssm":
            cache["conv"] = z((L, batch, a.conv_width - 1, a.d_inner + 2 * a.ssm_state), dt)
            cache["ssm"] = z((L, batch, a.ssm_n_heads, a.ssm_headdim, a.ssm_state),
                             torch.float32)
        return cache

    def decode_step(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    pos: int) -> torch.Tensor:
        """One autoregressive step at position ``pos``: tokens [B] -> fp32
        logits [B,V]. ``cache`` is updated in place: the KV slots of
        ``pos``, or the conv windows and SSM states (``lm._decode_ssm``)."""
        x = self.embed[tokens][:, None]
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, {name: c[i] for name, c in cache.items()}, pos)
        logits = rmsnorm(x, self.final_norm) @ self.lm_head
        return logits[:, 0].float()


def loss_fn(model: LM, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """``repro.models.lm.loss_fn``: next-token cross entropy in the
    logsumexp form on fp32 logits. batch: ``tokens`` and ``labels`` [B,S],
    optional ``loss_mask`` [B,S] (the mean over its ones, at least one).
    Returns (loss, {"loss": loss})."""
    logits = model(batch["tokens"])
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = lse - ll
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        mask = mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss}


def _dense(gen: torch.Generator, shape, scale: float, cfg: RunCfg, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale
    return w.to(cfg.compute_dtype)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32, device=device)


@torch.no_grad()
def init_params(arch: ArchConfig, generator: torch.Generator, cfg: RunCfg = RunCfg(),
                device=None) -> LM:
    """A model with random weights drawn from ``generator`` (which must live
    on ``device``), with the shapes and scales of ``repro.models.lm.init_params``.

    The reference's ``_dense`` takes fan-in from the first dim of the
    layer-stacked leaf, which is L: wq, wk, wv, wi, wg and in_proj have std
    (1/L)^0.5. That is kept, so both packages draw from one distribution.
    The SSM leaves follow ``lm._ssm_layer_params``: conv_w std 0.3, conv_b
    0, A_log = log U(1, 16), D = 1, dt_bias the inverse softplus of
    U(1e-3, 1e-1)."""
    model = LM(arch, cfg, device)
    dev = model.device
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the model on {dev}")
    L = arch.num_layers
    stacked = (1.0 / L) ** 0.5
    out_attn = ((1.0 / (arch.n_heads * arch.head_dim)) ** 0.5 / (2 * L) ** 0.5
                if arch.n_heads else 0.0)
    out_mlp = (1.0 / arch.d_ff) ** 0.5 / (2 * L) ** 0.5 if arch.d_ff else 0.0
    out_ssm = (1.0 / arch.d_inner) ** 0.5 / (2 * L) ** 0.5 if arch.d_inner else 0.0
    for blk in model.blocks:
        blk.norm1.fill_(1.0)
        if arch.has_attention:
            for name in ("wq", "wk", "wv"):
                blk.attn[name].copy_(_dense(generator, blk.attn[name].shape, stacked, cfg, dev))
            blk.attn["wo"].copy_(_dense(generator, blk.attn["wo"].shape, out_attn, cfg, dev))
        if arch.block == "ssm":
            p = blk.ssm
            p["in_proj"].copy_(_dense(generator, p["in_proj"].shape, stacked, cfg, dev))
            p["conv_w"].copy_(_dense(generator, p["conv_w"].shape, 0.3, cfg, dev))
            p["conv_b"].zero_()
            p["A_log"].copy_(torch.log(_uniform(generator, p["A_log"].shape, 1.0, 16.0, dev)))
            p["D"].fill_(1.0)
            dt = _uniform(generator, p["dt_bias"].shape, 1e-3, 1e-1, dev)
            p["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))     # inverse softplus
            p["ssm_norm"].fill_(1.0)
            p["out_proj"].copy_(_dense(generator, p["out_proj"].shape, out_ssm, cfg, dev))
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
