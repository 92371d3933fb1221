"""The LM of the port, ``repro.models.lm``: the attention, SSM and hybrid
blocks (``block`` "attn", "ssm", "hymba") and the MLP or MoE sublayer, over
token inputs or, for the stub-frontend archs (``embeds_input``: the
encoder hubert-xlarge, the VLM backbone llava-next-34b), precomputed
embeddings [B,S,H], with no ``embed`` table.

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

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..parallel.comm import MeshComm, gather_dim, local
from ..parallel.sharding import MeshPlacements, ShardingPlanner, mesh_device
from .layers import (attention, decode_attention, mlp, moe, moe_ep, rmsnorm, rmsnorm_sharded,
                     rope_qk, softplus, ssd_scan, ssm_decode_step)

__all__ = ["RunCfg", "LM", "Block", "init_params", "loss_fn", "param_count"]


@dataclass(frozen=True)
class RunCfg:
    """Mirrors ``repro.models.lm.RunCfg`` with torch dtypes. ``q_chunk`` has
    no counterpart (the flash kernel is tiled), nor ``ssd_chunk``: no
    caller changes its 256, the plain SSD version's default chunk (the SSD
    kernel blocks by its own); ``scan_layers`` has none (the layers are a
    loop), nor ``batch_axes`` (the mesh sets it), nor ``expert_axis``: the
    expert-parallel ``layers.moe_ep`` runs over "model", the reference's
    default, which no caller changes. ``capacity_factor`` sets the MoE
    layer's slots an expert (``layers.moe``, ``layers.moe_ep``).
    ``param_dtype`` is the type of training's master weights. ``remat``
    recomputes each ``Block`` in the backward (``torch.utils.checkpoint``,
    the reference's ``jax.checkpoint`` of the layer body); it acts only
    where autograd records. Logits are always
    fp32 (the reference's default ``logits_fp32=True``, which no caller
    changes).

    Distribution: ``mesh`` is a ``DeviceMesh`` with axes ("data", "model")
    or ("pod", "data", "model") (None: one device), the batch sharded over
    all but "model" (``MeshComm.batch_axes``); ``seq_shard`` keeps the
    residual stream sharded over "model" on the sequence between blocks."""

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    capacity_factor: float = 1.25
    mesh: Any = None
    seq_shard: bool = False


def _check_supported(arch: ArchConfig) -> None:
    if arch.block not in ("attn", "ssm", "hymba"):
        raise NotImplementedError(f"{arch.name}: block={arch.block!r} is unknown")


@dataclass(frozen=True)
class _Part:
    """Where a rank's block of one decode-cache leaf sits, in a layer's
    slice [B, ...] (``LM._cache_parts``). ``rows``: the rows this rank
    computes within its block, where the block holds every row while the
    rows are computed a "data" shard at a time (its updates are then
    gathered over "data", so the replicas stay equal); ``dim``: the dim
    sharded over "model" (None: replicated over it); ``start``: this
    rank's first index on ``dim``."""

    rows: Optional[slice] = None
    dim: Optional[int] = None
    start: int = 0


_WHOLE = _Part()
# the SSM mixer's leaves kept sharded over "model" on d_inner where it is head
# parallel (``Block.ssm_tp``)
_SSM_TAIL = ("ssm_norm", "out_proj")


def _empty(device, dtype, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


class Block(nn.Module):
    """One pre-norm layer: attention (``block="attn"``), the Mamba2 mixer
    (``block="ssm"``) or both in parallel on one normed input, their mean
    added (``block="hymba"``, ``lm._block``); then the MLP or, for MoE
    archs, the MoE layer (``lm._run_ffn``), where the arch has one.

    On a mesh (``plan_mesh``) the weights are DTensors, each gathered for
    the layer by ``MeshComm.weight``, and the residual [B_local, S or
    S/model, H] holds this rank's rows. The MoE layer is the
    expert-parallel ``layers.moe_ep`` over "model" (each rank its experts,
    on its rows' whole sequence). Attention is tensor parallel over
    whole heads where the q heads divide the "model" axis and each rank's q
    heads have their kv heads: wq, wk, wv column-parallel, wo row-parallel;
    where the kv heads do not divide the axis, wk and wv are gathered and a
    rank takes its q heads' kv head (Megatron replicates KV heads so). The
    MLP is tensor parallel where d_ff divides the axis. The SSM mixer is
    tensor parallel over whole SSM heads where they divide the axis and
    out_proj and ssm_norm are sharded over it on their d_inner dim
    (``ssm_tp``; rank r's block of them is then exactly heads [r nh/M,
    (r+1) nh/M)): in_proj, conv_w and conv_b are gathered and this rank's
    columns taken (z and x of its heads, B and C whole, dt of its heads:
    in_proj's columns interleave the five, so a column shard holds no whole
    head), the scan runs on its heads, the gated RMSNorm sums its squares
    over "model" (``layers.rmsnorm_sharded``), out_proj is row-parallel.
    Elsewhere (hymba-1.5b's 50 heads on a 4-, 8- or 16-way axis) the
    mixer's weights are gathered whole and every model rank computes it
    whole, as every other sublayer does."""

    def __init__(self, arch: ArchConfig, cfg: "RunCfg", device):
        super().__init__()
        self.arch, self.capacity_factor = arch, cfg.capacity_factor
        self.comm: Optional[MeshComm] = None
        self.attn_tp = self.kv_tp = self.mlp_tp = self.ssm_tp = False
        dtype = cfg.compute_dtype
        H, nh, nkv, hd, F = arch.d_model, arch.n_heads, arch.n_kv, arch.head_dim, arch.d_ff
        e = lambda *shape: _empty(device, dtype, *shape)
        self.norm1 = e(H)
        if arch.has_attention:
            self.attn = nn.ParameterDict({"wq": e(H, nh * hd), "wk": e(H, nkv * hd),
                                          "wv": e(H, nkv * hd), "wo": e(nh * hd, H)})
        if arch.block in ("ssm", "hymba"):
            di, N, K = arch.d_inner, arch.ssm_state, arch.conv_width
            f32 = lambda *shape: _empty(device, torch.float32, *shape)
            self.ssm = nn.ParameterDict({
                "in_proj": e(H, 2 * di + 2 * N + arch.ssm_n_heads),
                "conv_w": e(K, di + 2 * N), "conv_b": f32(di + 2 * N),
                "A_log": f32(arch.ssm_n_heads), "D": f32(arch.ssm_n_heads),
                "dt_bias": f32(arch.ssm_n_heads), "ssm_norm": e(di), "out_proj": e(di, H)})
        if arch.has_attention and (F or arch.n_experts):
            self.norm2 = e(H)
            if arch.n_experts:
                E, Fe = arch.n_experts, arch.d_ff_expert
                self.moe = nn.ParameterDict({"router": e(H, E), "wg": e(E, H, Fe),
                                             "wi": e(E, H, Fe), "wo": e(E, Fe, H)})
            else:
                mlp_p = {"wi": e(H, F), "wo": e(F, H)}
                if arch.mlp == "gated_silu":
                    mlp_p["wg"] = e(H, F)
                self.mlp = nn.ParameterDict(mlp_p)

    def plan_mesh(self, comm: MeshComm) -> None:
        """Take ``comm`` and pick the tensor-parallel sublayers from the
        weights' placements (the weights are DTensors already)."""
        a, M = self.arch, comm.size
        self.comm = comm
        if a.has_attention:
            p = self.attn
            per_rank, group = a.n_heads // M, a.n_heads // a.n_kv
            tp = a.n_heads % M == 0 and comm.tp_shard(p["wq"], 1) and comm.tp_shard(p["wo"], 0)
            self.kv_tp = tp and a.n_kv % M == 0 and comm.tp_shard(p["wk"], 1)
            # without kv shards, each rank's q heads must share one kv head
            self.attn_tp = tp and (self.kv_tp or group % per_rank == 0)
        if hasattr(self, "mlp"):
            self.mlp_tp = all(comm.tp_shard(w, 0 if n == "wo" else 1)
                              for n, w in self.mlp.items())
        if hasattr(self, "ssm"):
            p = self.ssm
            self.ssm_tp = (a.ssm_n_heads % M == 0 and comm.tp_shard(p["out_proj"], 0)
                           and comm.tp_shard(p["ssm_norm"], 0))

    def _w(self, p: torch.Tensor, partial: bool = False) -> torch.Tensor:
        """Weight ``p`` whole, as a layer every model rank computes whole uses
        it: itself on one device, else gathered (``MeshComm.weight``)."""
        return p if self.comm is None else self.comm.weight(p, None, partial)

    def _attn_weights(self, seq: bool):
        """(wq, wk, wv, wo, q heads, kv heads) this rank computes with."""
        a, p, c = self.arch, self.attn, self.comm
        if c is None or not self.attn_tp:
            return (*(self._w(p[n], seq) for n in ("wq", "wk", "wv", "wo")),
                    a.n_heads, a.n_kv)
        nh = a.n_heads // c.size
        if self.kv_tp:
            wk, wv, nkv = c.weight(p["wk"], 1), c.weight(p["wv"], 1), a.n_kv // c.size
        else:                            # this rank's q heads share kv head kv0
            hd, kv0 = a.head_dim, (c.rank * nh) // (a.n_heads // a.n_kv)
            cols = slice(kv0 * hd, (kv0 + 1) * hd)
            wk, wv, nkv = self._w(p["wk"], True)[:, cols], self._w(p["wv"], True)[:, cols], 1
        return c.weight(p["wq"], 1), wk, wv, c.weight(p["wo"], 0), nh, nkv

    def _qkv(self, h: torch.Tensor, positions: torch.Tensor, wq, wk, wv, nh: int, nkv: int):
        hd = self.arch.head_dim
        B, S, _ = h.shape
        q = (h @ wq).reshape(B, S, nh, hd)
        k = (h @ wk).reshape(B, S, nkv, hd)
        v = (h @ wv).reshape(B, S, nkv, hd)
        return (*rope_qk(q, k, positions), v)

    def _enter(self, h: torch.Tensor, tp: bool, seq: bool) -> torch.Tensor:
        """A sublayer's whole input rows (``MeshComm.tp_in`` / ``rep_in``)."""
        c = self.comm
        if c is None:
            return h
        return c.tp_in(h, seq) if tp else c.rep_in(h, seq)

    def _leave(self, y: torch.Tensor, tp: bool, seq: bool) -> torch.Tensor:
        """A sublayer's output in the residual's layout (``tp_out`` / ``rep_out``)."""
        c = self.comm
        if c is None:
            return y
        return c.tp_out(y, seq) if tp else c.rep_out(y, seq)

    def _ffn(self, x: torch.Tensor, seq: bool = False):
        """``lm._run_ffn``: x plus the MLP or MoE of its pre-norm -> (x,
        aux). aux is {} without experts, else the layer's
        {"moe_drop", "moe_load_max"} (fp32 scalars)."""
        a, c = self.arch, self.comm
        if not hasattr(self, "norm2"):
            return x, {}
        h = rmsnorm(x, self._w(self.norm2, seq))
        if not a.n_experts:
            if c is not None and self.mlp_tp:
                w = {n: c.weight(p, 0 if n == "wo" else 1) for n, p in self.mlp.items()}
            else:
                w = {n: self._w(p, seq) for n, p in self.mlp.items()}
            y = mlp(self._enter(h, self.mlp_tp, seq), w, a.mlp)
            return x + self._leave(y, self.mlp_tp, seq), {}
        gated = a.mlp == "gated_silu"
        if c is None:
            out, aux = moe(h.reshape(-1, h.shape[-1]), self.moe, a.top_k, self.capacity_factor,
                           gated=gated)
        else:
            out, aux = moe_ep(h if seq else h.reshape(-1, h.shape[-1]), self.moe, a.top_k, c,
                              self.capacity_factor, gated=gated, seq=seq)
        return x + out.reshape(x.shape), {"moe_drop": aux["drop_fraction"],
                                          "moe_load_max": aux["load"].max().to(torch.float32)}

    def _attn(self, h: torch.Tensor, positions: torch.Tensor, seq: bool = False) -> torch.Tensor:
        """``lm._run_attn``: h [B,S,H] -> [B,S,H] through the flash kernel."""
        y = self._attn_rows(self._enter(h, self.attn_tp, seq), positions, seq)
        return self._leave(y, self.attn_tp, seq)

    def _attn_rows(self, h: torch.Tensor, positions: torch.Tensor, seq: bool) -> torch.Tensor:
        """Attention of whole rows h [B,S,H]: the output, or on a tensor
        parallel mesh this rank's heads' partial sum of it."""
        wq, wk, wv, wo, nh, nkv = self._attn_weights(seq)
        B, S, _ = h.shape
        q, k, v = self._qkv(h, positions, wq, wk, wv, nh, nkv)
        o = attention(q, k, v, causal=self.arch.causal, window=self.arch.window)
        return o.reshape(B, S, -1) @ wo

    def _attn_decode(self, h: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
                     part: _Part = _WHOLE) -> torch.Tensor:
        """``lm._decode_attn``: h [B,1,H] -> [B,1,H]. Writes this token's k, v
        into slot ``pos`` of the layer's cache, ``pos % span`` for window
        archs (a ring of ``span`` slots), and attends over the
        ``min(pos + 1, span)`` slots written. On a mesh every weight is
        gathered whole and the span may be split over "model" (``part``):
        the rank that holds the slot writes it, and each attends over its
        own valid slots, the softmax reduced over "model"
        (``layers.decode_attention``)."""
        a = self.arch
        B = h.shape[0]
        posb = torch.full((B, 1), pos, device=h.device)
        wq, wk, wv, wo = (self._w(self.attn[n]) for n in ("wq", "wk", "wv", "wo"))
        q, k, v = self._qkv(h, posb, wq, wk, wv, a.n_heads, a.n_kv)
        k_cache, v_cache = cache["k"], cache["v"]
        held = k_cache.shape[1]                       # this rank's slots
        span = held if part.dim is None else held * self.comm.size
        slot = (pos % span if a.window else pos) - part.start
        if 0 <= slot < held:
            k_cache[:, slot] = self._rows_whole(k[:, 0], part)
            v_cache[:, slot] = self._rows_whole(v[:, 0], part)
        if part.rows is not None:
            k_cache, v_cache = k_cache[part.rows], v_cache[part.rows]
        valid = max(0, min(min(pos + 1, span) - part.start, held))
        group = None if part.dim is None else self.comm.group
        o = decode_attention(q, k_cache, v_cache, valid, group)
        return o.reshape(B, 1, -1) @ wo

    def _rows_whole(self, t: torch.Tensor, part: _Part) -> torch.Tensor:
        """This rank's rows ``t`` of a cache update, gathered over "data"
        where the cache block holds every row (``_Part.rows``)."""
        if part.rows is None:
            return t
        return gather_dim(t, 0, self.comm.groups[self.comm.data_dim])

    def _split(self, proj: torch.Tensor, nh: int):
        """in_proj's output of ``nh`` heads -> z [.,nh hp], xbc [.,nh hp + 2N],
        dt's input [.,nh]."""
        a = self.arch
        d = nh * a.ssm_headdim
        return proj.split([d, d + 2 * a.ssm_state, nh], dim=-1)

    def _ssm_weights(self, partial: bool):
        """(weights, heads) the mixer computes with on this rank: each weight
        whole (``_w``), or where the mixer is head parallel (``ssm_tp``)
        this rank's heads' part of it: in_proj's columns [z_r | x_r | B | C
        | dt_r] and conv_w's and conv_b's [x_r | B | C] taken from the
        gathered leaves in one copy each, A_log, D and dt_bias sliced, the
        model shards of ssm_norm and out_proj kept. With one model rank
        the parts are the whole leaves, used as they are."""
        a, c = self.arch, self.comm
        if c is None or not self.ssm_tp:
            return {n: self._w(w, partial) for n, w in self.ssm.items()}, a.ssm_n_heads
        nh = a.ssm_n_heads // c.size
        p = {n: self._w(self.ssm[n], True)
             for n in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias")}
        for n in _SSM_TAIL:
            p[n] = c.weight(self.ssm[n], 0)
        if c.size > 1:
            di, N, hp = a.d_inner, a.ssm_state, a.ssm_headdim
            h0 = c.rank * nh
            r0, d = h0 * hp, nh * hp
            cols = lambda w, *spans: torch.cat([w[..., s:s + n] for s, n in spans], dim=-1)
            p["in_proj"] = cols(p["in_proj"], (r0, d), (di + r0, d), (2 * di, 2 * N),
                                (2 * di + 2 * N + h0, nh))
            for n in ("conv_w", "conv_b"):
                p[n] = cols(p[n], (r0, d), (di, 2 * N))
            for n in ("A_log", "D", "dt_bias"):
                p[n] = p[n][h0:h0 + nh]
        return p, nh

    def _gated_norm(self, y: torch.Tensor, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """rmsnorm(y silu(z), ssm_norm) of this rank's columns: whole rows
        through the RMSNorm kernel, or with the heads split over more than
        one model rank ``layers.rmsnorm_sharded`` over all d_inner."""
        g = y * F.silu(z)
        c = self.comm
        if c is None or not self.ssm_tp or c.size == 1:
            return rmsnorm(g, w)
        return rmsnorm_sharded(g, w, self.arch.d_inner, c.group)

    def _ssm(self, h: torch.Tensor, seq: bool = False) -> torch.Tensor:
        """``lm._run_ssm`` (prefill): h [B,S,H] -> [B,S,H]. The causal
        depthwise conv is the reference's K shifted multiply-adds in the
        activation type (not ``F.conv1d``: that keeps its rounding, and
        keeps cuDNN's TF32 off the fp32 path); the fp32 leaves are rounded
        to the compute dtype, as the reference's ``forward`` casts them.
        SiLU is ``F.silu``, computed in fp32 and rounded once for bf16, as
        XLA fuses the reference's ``x * sigmoid(x)``: with two bf16
        roundings the port's bf16 gradients of A_log and dt_bias sat 1.9x
        further from fp32 than the reference's own bf16 (tiny mamba2,
        tests/test_torch_train.py). The MLP's ``silu`` keeps its two."""
        y = self._ssm_rows(self._enter(h, self.ssm_tp, seq), seq)
        return self._leave(y, self.ssm_tp, seq)

    def _ssm_rows(self, h: torch.Tensor, partial: bool) -> torch.Tensor:
        """The mixer of whole rows h [B,S,H]: the output, or where it is
        head parallel this rank's heads' partial sum of it; ``partial``:
        the whole weights' gradients on this rank are a part of theirs."""
        a = self.arch
        p, nh = self._ssm_weights(partial)
        B, S, _ = h.shape
        N, hp, K = a.ssm_state, a.ssm_headdim, a.conv_width
        d, cdt = nh * hp, h.dtype
        z, xbc, dtr = self._split(h @ p["in_proj"], nh)
        padded = F.pad(xbc, (0, 0, K - 1, 0))
        conv = sum(padded[:, k:k + S] * p["conv_w"][k] for k in range(K)) + p["conv_b"].to(cdt)
        xs, Bm, Cm = F.silu(conv).split([d, N, N], dim=-1)
        acc = torch.promote_types(cdt, torch.float32)          # fp32, or fp64 for fp64
        dt = softplus(dtr.to(acc) + p["dt_bias"].to(cdt).to(acc))
        A = -torch.exp(p["A_log"].to(cdt))
        x4 = xs.reshape(B, S, nh, hp)
        y = ssd_scan(x4, dt, A, Bm, Cm)
        y = y + p["D"].to(cdt)[:, None] * x4
        return self._gated_norm(y.reshape(B, S, d), z, p["ssm_norm"]) @ p["out_proj"]

    def _ssm_decode(self, h: torch.Tensor, conv_cache: torch.Tensor, ssm_cache: torch.Tensor,
                    parts: Optional[Dict[str, _Part]] = None) -> torch.Tensor:
        """``lm._decode_ssm``: h [B,1,H] -> [B,1,H]. Updates the layer's
        conv cache [B,K-1,conv_dim] and SSM state [B,nh,hp,N] in place. The
        fp32 leaves stay fp32, as in the reference's decode, so the conv
        sum and its SiLU run in fp32 before the cast.

        On a mesh (``parts``) each rank updates its block of the caches: the
        conv on its channels (then the conv's output gathered over
        "model"), the recurrence on its heads, or its slice of the head dim
        (then y gathered over "model"). Every step is per channel or per
        (head, hp), so the split is exact. Where the state is split by heads
        and the mixer is head parallel (``ssm_tp``), y stays on this rank's
        heads: the D skip, the gated norm (``_gated_norm``) and a
        row-parallel out_proj, then one all-reduce of [B,1,H]; every other
        weight is gathered whole."""
        a, c = self.arch, self.comm
        B = h.shape[0]
        di, N, nh, hp = a.d_inner, a.ssm_state, a.ssm_n_heads, a.ssm_headdim
        pc, ps = (_WHOLE, _WHOLE) if parts is None else (parts["conv"], parts["ssm"])
        tp = self.ssm_tp and ps.dim == 1
        p = {n: c.weight(w, 0) if tp and n in _SSM_TAIL else self._w(w)
             for n, w in self.ssm.items()}
        z, xbc, dtr = self._split((h @ p["in_proj"])[:, 0], nh)
        cols = slice(pc.start, pc.start + conv_cache.shape[-1])     # this rank's channels
        held = conv_cache if pc.rows is None else conv_cache[pc.rows]
        hist = torch.cat([held, xbc[:, None, cols]], dim=1)          # [B,K,channels]
        conv = (hist * p["conv_w"][:, cols]).sum(dim=1) + p["conv_b"][cols]
        conv_cache.copy_(self._rows_whole(hist[:, 1:], pc))
        act = F.silu(conv).to(h.dtype)
        if pc.dim is not None:
            act = gather_dim(act, 1, c.group)
        xs, Bm, Cm = act.split([di, N, N], dim=-1)
        dt = softplus(dtr.float() + p["dt_bias"])
        A = -torch.exp(p["A_log"])
        x3 = xs.reshape(B, nh, hp)
        state = ssm_cache if ps.rows is None else ssm_cache[ps.rows]
        if ps.dim == 1:                                             # this rank's heads
            hs = slice(ps.start, ps.start + state.shape[1])
            y, new_state = ssm_decode_step(x3[:, hs], dt[:, hs], A[hs], Bm, Cm, state)
        elif ps.dim == 2:                                           # its part of hp
            y, new_state = ssm_decode_step(x3[:, :, ps.start:ps.start + state.shape[2]], dt, A,
                                           Bm, Cm, state)
        else:
            y, new_state = ssm_decode_step(x3, dt, A, Bm, Cm, state)
        ssm_cache.copy_(self._rows_whole(new_state, ps))
        if tp:
            d = state.shape[1] * hp
            y = y + p["D"][hs].to(y.dtype)[:, None] * x3[:, hs]
            y = self._gated_norm(y.reshape(B, 1, d), z[:, None, hs.start * hp:hs.start * hp + d],
                                 p["ssm_norm"])
            return c.tp_out(y @ p["out_proj"], False)
        if ps.dim is not None:
            y = gather_dim(y, ps.dim, c.group)
        y = y + p["D"].to(y.dtype)[:, None] * x3
        return rmsnorm(y.reshape(B, 1, di) * F.silu(z)[:, None], p["ssm_norm"]) @ p["out_proj"]

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B,S,H] -> (x [B,S,H], aux: {} or the MoE layer's stats). On a
        mesh x may be a sequence shard [B,S/model,H]; ``positions`` is
        [B,S] either way."""
        seq = x.shape[1] != positions.shape[1]
        h = rmsnorm(x, self._w(self.norm1, seq))
        block = self.arch.block
        if block == "attn":
            x = x + self._attn(h, positions, seq)
        elif block == "ssm":
            x = x + self._ssm(h, seq)
        elif self.comm is not None and (self.attn_tp or self.ssm_tp):
            # hymba with parallel heads: one way in and out for both mixers;
            # a mixer computed whole adds its share 1/model a rank (exact for
            # a power of two), so the gradients add up in the order they do
            # on one device
            c = self.comm
            h = c.tp_in(h, seq)
            ya, ys = self._attn_rows(h, positions, True), self._ssm_rows(h, True)
            y = (ya if self.attn_tp else ya / c.size) + (ys if self.ssm_tp else ys / c.size)
            x = x + c.tp_out(0.5 * y, seq)
        else:                               # hymba: parallel attn + mamba heads, mean
            x = x + 0.5 * (self._attn(h, positions, seq) + self._ssm(h, seq))
        return self._ffn(x, seq)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
               parts: Optional[Dict[str, _Part]] = None) -> torch.Tensor:
        """One token: x [B,1,H]; ``cache`` holds this layer's slices of the
        model's cache, updated in place (the reference returns a new
        cache): k, v [B,span,nkv,hd] get this token's k, v; conv and ssm
        get the new conv window and SSM state. On a mesh, x holds this
        rank's rows, ``cache`` its blocks and ``parts`` where they sit."""
        h = rmsnorm(x, self._w(self.norm1))
        block = self.arch.block
        if block != "ssm":
            a = self._attn_decode(h, cache, pos, _WHOLE if parts is None else parts["k"])
        if block != "attn":
            s = self._ssm_decode(h, cache["conv"], cache["ssm"], parts)
        x = x + (a if block == "attn" else s if block == "ssm" else 0.5 * (a + s))
        return self._ffn(x)[0]


class LM(nn.Module):
    """Embed (token archs only), ``num_layers`` blocks, final norm, head.

    With ``cfg.mesh`` the model lives on that mesh: every weight is a
    DTensor at ``ShardingPlanner``'s placements, each rank allocating its
    shard only (uninitialised, as on one device; ``init_params`` and
    ``train.step.init_train_state`` fill them from full weights). The
    forward then takes this rank's batch rows and returns their logits,
    the same on every rank of the "model" axis; so does ``decode_step``,
    over a cache that ``init_cache`` places as ``ShardingPlanner.cache``
    says (context-parallel KV over "model", the SSM state's heads over
    it)."""

    def __init__(self, arch: ArchConfig, cfg: RunCfg = RunCfg(), device=None):
        super().__init__()
        _check_supported(arch)
        device = resolve_device(device) if cfg.mesh is None else mesh_device(cfg.mesh)
        self.arch, self.cfg, self._device = arch, cfg, device
        build = device if cfg.mesh is None else torch.device("meta")
        dt, H, V = cfg.compute_dtype, arch.d_model, arch.vocab
        if not arch.embeds_input:       # the reference makes no embed leaf for the others
            self.embed = _empty(build, dt, V, H)
        self.blocks = nn.ModuleList(Block(arch, cfg, build) for _ in range(arch.num_layers))
        self.final_norm = _empty(build, dt, H)
        self.lm_head = _empty(build, dt, H, V)
        self.comm: Optional[MeshComm] = None
        if cfg.mesh is not None:
            self._distribute(cfg.mesh)

    def _distribute(self, mesh) -> None:
        """Replace every (meta) weight by an empty DTensor at the planner's
        placements, then plan the blocks' tensor parallelism."""
        planner = ShardingPlanner(mesh, self.arch)
        for name, pl in planner.params(self).items():
            *path, leaf = name.split(".")
            owner = self.get_submodule(".".join(path))
            old = owner[leaf] if isinstance(owner, nn.ParameterDict) else getattr(owner, leaf)
            w = nn.Parameter(MeshPlacements(mesh, pl).empty(old.shape, old.dtype, self._device))
            if isinstance(owner, nn.ParameterDict):
                owner[leaf] = w
            else:
                setattr(owner, leaf, w)
        self.comm = MeshComm(mesh, self.cfg.seq_shard)
        for blk in self.blocks:
            blk.plan_mesh(self.comm)

    @property
    def device(self) -> torch.device:
        return self._device

    def _input(self, tokens, embeds, seq: bool = False) -> torch.Tensor:
        """The first activation: embeds cast to the compute dtype for an
        embeds-input arch (the reference's ``forward`` and ``decode_step``),
        else the embed rows of tokens; raises when the arch's input is
        missing. ``seq``: on a mesh, the rows will be cut to this rank's
        sequence shard (the embed's gradient is then partial)."""
        if self.arch.embeds_input:
            if embeds is None:
                raise ValueError(f"{self.arch.name} takes precomputed embeddings (embeds=)")
            return embeds.to(self.cfg.compute_dtype)
        if tokens is None:
            raise ValueError(f"{self.arch.name} takes tokens")
        embed = self.embed if self.comm is None else self.comm.weight(self.embed, None, seq)
        return embed[tokens]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head of whole rows -> logits in the compute dtype.
        On a mesh the head is column-parallel over the vocab where V divides
        "model" (the reference's vocab-sharded logits, ``lm.py:308``), and
        the logits are gathered over "model" before the loss."""
        c = self.comm
        if c is None:
            return rmsnorm(x, self.final_norm) @ self.lm_head
        h = rmsnorm(x, c.weight(self.final_norm))
        if c.tp_shard(self.lm_head, 1):
            return c.vocab_full(c.tp_in(h, False) @ c.weight(self.lm_head, 1))
        return h @ c.weight(self.lm_head)

    def forward(self, tokens: Optional[torch.Tensor] = None, logits_positions: str = "all",
                with_aux: bool = False, embeds: Optional[torch.Tensor] = None):
        """tokens [B,S] (token archs) or embeds [B,S,H] (embeds-input archs)
        -> fp32 logits [B,S,V] (fp64 for an fp64 model), or [B,1,V] with
        ``logits_positions="last"`` (prefill: no [B,S,V] buffer). With
        ``with_aux``, (logits, aux): aux is {} without experts, else
        {"moe_drop", "moe_load_max"}, each the mean over the layers (the
        reference's ``lax.scan`` then ``jnp.mean``). On a mesh, inputs and
        logits are this rank's batch rows; with ``seq_shard`` the residual
        between blocks is this rank's sequence shard."""
        c = self.comm
        raw = embeds if self.arch.embeds_input else tokens
        seq = c is not None and raw is not None and c.seq_sharded(raw.shape[1])
        x = self._input(tokens, embeds, seq)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        if seq:
            x = c.seq_local(x)
        remat = self.cfg.remat and torch.is_grad_enabled()
        per_layer = []
        for blk in self.blocks:
            x, aux = (checkpoint(blk, x, positions, use_reentrant=False) if remat
                      else blk(x, positions))
            per_layer.append(aux)
        if seq:
            x = c.seq_full(x)
        if logits_positions == "last":
            x = x[:, -1:]
        logits = self._logits(x)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        if not with_aux:
            return logits
        return logits, {k: torch.stack([a[k] for a in per_layer]).mean() for k in per_layer[0]}

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Attention archs: KV cache k, v [L,B,span,nkv,hd] in the compute
        dtype; window archs keep a ring buffer of ``window`` positions. SSM
        and hybrid archs: the conv window [L,B,K-1,conv_dim] in the compute
        dtype and the state [L,B,nh,hp,N] in fp32, whatever ``max_len``
        (hybrid archs keep both sets). Zeros. On a mesh each leaf is a
        DTensor at ``ShardingPlanner.cache``'s placements (B over "data",
        the span, the conv channels and the SSM heads, or else hp, over
        "model", each where it divides), each rank allocating its block."""
        a, L, dt = self.arch, self.arch.num_layers, self.cfg.compute_dtype
        shapes = {}
        if a.has_attention:
            span = min(a.window, max_len) if a.window else max_len
            shapes["k"] = shapes["v"] = ((L, batch, span, a.n_kv, a.head_dim), dt)
        if a.block in ("ssm", "hymba"):
            shapes["conv"] = ((L, batch, a.conv_width - 1, a.d_inner + 2 * a.ssm_state), dt)
            shapes["ssm"] = ((L, batch, a.ssm_n_heads, a.ssm_headdim, a.ssm_state),
                             torch.float32)
        if self.comm is None:
            return {n: torch.zeros(shape, dtype=d, device=self.device)
                    for n, (shape, d) in shapes.items()}
        mesh = self.cfg.mesh
        placed = ShardingPlanner(mesh, a).cache({n: shape for n, (shape, _) in shapes.items()})
        cache = {}
        for n, (shape, d) in shapes.items():
            cache[n] = MeshPlacements(mesh, placed[n]).empty(shape, d, self.device)
            local(cache[n]).zero_()
        return cache

    def _cache_parts(self, cache: Dict[str, torch.Tensor], rows: int) -> Dict[str, _Part]:
        """Where this rank's block of each cache leaf sits (``_Part``), for a
        step over ``rows`` rows: all B where B does not divide "data",
        else this "data" rank's shard of them."""
        c = self.comm
        parts = {}
        for name, t in cache.items():
            pl = t.placements
            taken = None
            if rows != t.shape[1] and not pl[c.data_dim].is_shard(1):
                r0 = c.mesh.get_local_rank(c.data_dim) * rows
                taken = slice(r0, r0 + rows)
            model = pl[c.model_dim]
            if model.is_shard():
                parts[name] = _Part(taken, model.dim - 1, c.rank * local(t).shape[model.dim])
            else:
                parts[name] = _Part(taken)
        return parts

    def decode_step(self, cache: Dict[str, torch.Tensor], tokens: Optional[torch.Tensor],
                    pos: int, embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One autoregressive step at position ``pos``: tokens [B] (or, for
        an embeds-input arch, embeds [B,H]) -> fp32 logits [B,V]. ``cache``
        is updated in place: the KV slots of ``pos`` and/or the conv
        windows and SSM states (``lm._decode_ssm``). On a mesh, ``cache``
        is ``init_cache``'s, and tokens and logits are this rank's rows:
        the batch over "data" where B divides it, else all of it
        (``serving.serve`` cuts and gathers them); each layer's weights are
        gathered whole a layer at a time (the reference's weight
        streaming), the MoE layer is ``moe_ep``."""
        x = self._input(tokens, embeds)[:, None]
        parts = None if self.comm is None else self._cache_parts(cache, x.shape[0])
        blocks = {n: local(c) for n, c in cache.items()}
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, {n: c[i] for n, c in blocks.items()}, pos, parts)
        return self._logits(x)[:, 0].float()


def loss_fn(model: LM, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """``repro.models.lm.loss_fn``: next-token (or frame-label) cross
    entropy in the logsumexp form on fp32 logits. batch: ``tokens`` [B,S]
    or ``embeds`` [B,S,H] (embeds-input archs), ``labels`` [B,S], optional
    ``loss_mask`` [B,S] (the mean over its ones, at least one). Returns
    (loss, {"loss": loss, **aux}): MoE archs add the forward's
    ``moe_drop`` and ``moe_load_max``.

    On a mesh the batch is this rank's rows and the first value is this
    rank's share of the loss, the one to differentiate: the local mean over
    the number of batch ranks, or the local masked sum over the global mask
    count (so a batch replicated over the batch axes, where B does not
    divide them, counts once). metrics["loss"] is the shares' sum over the
    batch axes, the loss."""
    logits, aux = model(batch.get("tokens"), with_aux=True, embeds=batch.get("embeds"))
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = lse - ll
    mask = batch.get("loss_mask")
    c = model.comm
    if mask is None:
        loss = nll.mean() if c is None else nll.mean() / c.batch_ranks()
    else:
        mask = mask.to(nll.dtype)
        count = mask.sum() if c is None else c.sum_over_batch(mask.sum())
        loss = (nll * mask).sum() / torch.clamp(count, min=1.0)
    total = loss if c is None else c.sum_over_batch(loss)
    return loss, {"loss": total, **aux}


# A leaf of more elements than this is drawn a block of rows at a time, so
# that drawing nemotron-4-340b's embed and head (4.7 B elements each) takes
# 4 GiB of fp32 scratch, not 19 GB beside the weights; every smaller leaf is
# drawn in one call, as the reference's _dense draws it.
_DRAW_BLOCK = 2 ** 30


def _dense(w: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill ``w`` with N(0, 1) * ``scale`` drawn in fp32 and rounded to
    ``w``'s dtype; past ``_DRAW_BLOCK`` elements a block of rows at a time
    (the same distribution, another stream of draws)."""
    rows = w.shape[0]
    if w.numel() > _DRAW_BLOCK:
        rows = max(1, _DRAW_BLOCK // w[0].numel())
    for r0 in range(0, w.shape[0], rows):
        part = w[r0:r0 + rows]
        part.copy_(torch.randn(part.shape, generator=gen, dtype=torch.float32,
                               device=w.device).mul_(scale))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32, device=device)


@torch.no_grad()
def init_params(arch: ArchConfig, generator: torch.Generator, cfg: RunCfg = RunCfg(),
                device=None) -> LM:
    """A model with random weights drawn from ``generator`` (which must live
    on ``device``), with the shapes and scales of ``repro.models.lm.init_params``.

    The reference's ``_dense`` takes fan-in from the first dim of the
    layer-stacked leaf, which is L: wq, wk, wv, wi, wg and in_proj have std
    (1/L)^0.5, and so do the experts' wg and wi (their stacked leaf is
    [L,E,H,F]). That is kept, so both packages draw from one distribution.
    The SSM leaves follow ``lm._ssm_layer_params``: conv_w std 0.3, conv_b
    0, A_log = log U(1, 16), D = 1, dt_bias the inverse softplus of
    U(1e-3, 1e-1); the MoE leaves ``lm._moe_layer_params``: router std
    0.02, wo (1/F)^0.5 / (2L)^0.5 with F = d_ff_expert.

    With ``cfg.mesh`` every rank draws the whole model (on the mesh's
    device) and keeps its shards: the weights of the single-device model.
    On the meta device (``launch.dryrun``) nothing is drawn and any
    generator will do."""
    if cfg.mesh is not None:
        whole = init_params(arch, generator, dataclasses.replace(cfg, mesh=None),
                            mesh_device(cfg.mesh))
        model = LM(arch, cfg)
        for (name, w), (_, full) in zip(model.named_parameters(), whole.named_parameters()):
            local(w).copy_(local(MeshPlacements(cfg.mesh, tuple(w.placements)).distribute(full)))
        return model
    model = LM(arch, cfg, device)
    dev = model.device
    if generator.device.type != dev.type and dev.type != "meta":   # a meta model draws nothing
        raise ValueError(f"generator is on {generator.device}, the model on {dev}")
    L = arch.num_layers
    stacked = (1.0 / L) ** 0.5
    out_attn = ((1.0 / (arch.n_heads * arch.head_dim)) ** 0.5 / (2 * L) ** 0.5
                if arch.n_heads else 0.0)
    out_mlp = (1.0 / arch.d_ff) ** 0.5 / (2 * L) ** 0.5 if arch.d_ff else 0.0
    out_moe = (1.0 / arch.d_ff_expert) ** 0.5 / (2 * L) ** 0.5 if arch.n_experts else 0.0
    out_ssm = (1.0 / arch.d_inner) ** 0.5 / (2 * L) ** 0.5 if arch.d_inner else 0.0
    for blk in model.blocks:
        blk.norm1.fill_(1.0)
        if arch.has_attention:
            for name in ("wq", "wk", "wv"):
                _dense(blk.attn[name], generator, stacked)
            _dense(blk.attn["wo"], generator, out_attn)
        if arch.block in ("ssm", "hymba"):
            p = blk.ssm
            _dense(p["in_proj"], generator, stacked)
            _dense(p["conv_w"], generator, 0.3)
            p["conv_b"].zero_()
            p["A_log"].copy_(torch.log(_uniform(generator, p["A_log"].shape, 1.0, 16.0, dev)))
            p["D"].fill_(1.0)
            dt = _uniform(generator, p["dt_bias"].shape, 1e-3, 1e-1, dev)
            p["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))     # inverse softplus
            p["ssm_norm"].fill_(1.0)
            _dense(p["out_proj"], generator, out_ssm)
        if hasattr(blk, "norm2"):
            blk.norm2.fill_(1.0)
            if arch.n_experts:
                scales = {"router": 0.02, "wg": stacked, "wi": stacked, "wo": out_moe}
                for name, p in blk.moe.items():
                    _dense(p, generator, scales[name])
            else:
                for name, p in blk.mlp.items():
                    scale = out_mlp if name == "wo" else stacked
                    _dense(p, generator, scale)
    model.final_norm.fill_(1.0)
    _dense(model.lm_head, generator, 0.02)
    if not arch.embeds_input:
        _dense(model.embed, generator, 0.02)
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
