"""Model primitives of the port: ``repro.models.layers``.

``rmsnorm``, ``rope_qk``, ``attention`` and ``ssd_scan`` go through the port's kernels
(``repro_torch.kernels``): the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors. The rest is plain PyTorch, as it is
plain JAX in the reference. Layouts are the reference's: activations
[B,S,H], attention tensors [B,S,nh,hd], SSM inputs [B,S,nh,hp], weights
[in,out] used as x @ w.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import kernels
from ..obs.registry import current
from ..parallel.comm import psum

__all__ = ["rmsnorm", "rmsnorm_sharded", "rope_qk", "attention", "decode_attention", "mlp", "moe",
           "moe_dropless", "moe_ep", "ssd_scan", "ssm_decode_step", "silu", "softplus",
           "squared_relu", "gelu"]


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``, with no
    threshold (``F.softplus`` returns x above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def squared_relu(x):
    r = torch.relu(x)
    return r * r


def gelu(x):
    # jax.nn.gelu defaults to approximate=True (tanh form); torch's does not
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"gated_silu": silu, "squared_relu": squared_relu, "gelu": gelu}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim, through the RMSNorm kernel on [T,H].

    Precision: the kernel multiplies by w in fp32 and casts once
    (``repro.kernels.ref.rmsnorm_ref``), while ``repro.models.layers.rmsnorm``
    casts to x's type first and multiplies in that type. The two agree
    exactly in fp32 and to bf16 rounding in bf16."""
    H = x.shape[-1]
    out = kernels.rmsnorm(x.reshape(-1, H).contiguous(), w.to(x.dtype), eps=eps)
    return out.reshape(x.shape)


def rmsnorm_sharded(x: torch.Tensor, w: torch.Tensor, width: int, group,
                    eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of rows split by columns over ``group``: x [..., width/n] this
    rank's columns, w [width/n] its block of the weight. The fp32 sum of
    squares of the local columns is summed over the group (``comm.psum``,
    whose backward sums too) and divided by ``width``; then the
    reference's order (``repro.models.layers.rmsnorm``): cast, times w in
    x's type. Eager ops: the RMSNorm kernel reduces whole rows."""
    acc = torch.promote_types(x.dtype, torch.float32)       # fp32, or fp64 for fp64
    xf = x.to(acc)
    ss = psum((xf * xf).sum(dim=-1, keepdim=True), group)
    return (xf * torch.rsqrt(ss / width + eps)).to(x.dtype) * w.to(x.dtype)


def rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
            theta: float = 10_000.0):
    """Rotary embedding of q [B,S,nh,hd] and k [B,S,nkv,hd] at ``positions``
    [B,S]: the reference's table (its lines, one table for both), then one
    launch of the rope kernel for the two (``kernels.rope``), whose
    arithmetic is ``repro.models.layers.rope``'s. Returns (q, k)."""
    half = q.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=q.device) / half))
    angles = positions[..., :, None].float() * freqs        # [B, S, half]
    return kernels.rope(q, k, torch.cos(angles), torch.sin(angles))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, scale: float = 0.0) -> torch.Tensor:
    """Training/prefill attention through the flash kernel.

    q: [B,S,nh,hd]; k,v: [B,S,nkv,hd]. Returns [B,S,nh,hd]. ``scale`` is
    the softmax scale (0: hd^-0.5, the reference's only one). The kernel
    takes strides, so the [B,nh,S,hd] views below cost no copy, and its
    output comes back in q's [B,S,nh,hd] layout. The reference's
    ``q_chunk`` (an O(S*chunk)-memory scan) has no counterpart: the kernel
    is tiled already.

    Precision, against the reference's ``_attend``:
    * scale and mask order: the kernel (and its plain version) forms q k^T
      in fp32, scales, then masks; ``_attend`` rounds q k^T to the input
      type, scales in that type, and only then goes to fp32 to mask;
    * probabilities: the kernel keeps m, l and the p v sum in fp32 (the
      bf16 kernel rounds the unnormalised p to bf16 only as the tensor-core
      operand; the plain version keeps p in fp32); ``_attend`` casts the
      normalised probabilities to v's type before p v.
    Both vanish in fp32 (tests/test_torch_models.py holds 1e-4 there)."""
    o = kernels.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                causal=causal, window=window, scale=scale)
    return o.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, group=None, scale: float = 0.0) -> torch.Tensor:
    """q: [B,1,nh,hd]; caches [B,S_max,nkv,hd]; ``cache_len`` valid slots
    (new token included); ``scale`` the softmax scale (0: hd^-0.5). Plain
    PyTorch, as the reference's ``_attend``:
    scores in the input type, the softmax in fp32 (row max, exp, row sum,
    divide), probabilities cast to v's type before p v. The slots past
    ``cache_len``, which the reference masks, are sliced off instead; they
    would add exact zeros to the softmax.

    With ``group``, the caches are this rank's shard of a span split over
    the group's ranks (context parallel) and ``cache_len`` counts the valid
    slots of this shard, maybe none: the row max is all-reduced (MAX), the
    row sum and the partial outputs all-reduced (SUM), the order GSPMD
    partitions the reference's ``_attend`` into. On one rank that is this
    function's arithmetic without a group."""
    B, Sq, nh, hd = q.shape
    nkv = k_cache.shape[2]
    qg = q.reshape(B, Sq, nkv, nh // nkv, hd)
    k, v = k_cache[:, :cache_len], v_cache[:, :cache_len]
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * (scale or hd ** -0.5)
    s32 = scores.float()
    if cache_len:
        m = s32.amax(dim=-1, keepdim=True)
    else:                                  # no valid slot here: -inf, 0, 0
        m = s32.new_full((*s32.shape[:-1], 1), float("-inf"))
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s32 - m)
    denom = e.sum(dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(denom, group=group)
    out = torch.einsum("bkgqs,bskh->bqkgh", (e / denom).to(v.dtype), v)
    if group is not None:
        out = out.contiguous()
        dist.all_reduce(out, group=group)
    return out.reshape(B, Sq, nh, hd)


def mlp(x: torch.Tensor, params: Mapping[str, torch.Tensor], kind: str) -> torch.Tensor:
    """Gated-SiLU (3 matmuls) / squared-ReLU / GELU (2 matmuls)."""
    if kind == "gated_silu":
        return (silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]
    return ACTIVATIONS[kind](x @ params["wi"]) @ params["wo"]


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int, pad: int = 0):
    """The router in fp32 (fp64 for fp64 x): softmax over the experts and
    ``pad`` more columns at -inf (an expert-parallel layer's padding), top-k,
    gates renormalised. Returns (probs, gates [T,k], experts [T,k])."""
    acc = torch.promote_types(x.dtype, torch.float32)
    logits = x.to(acc) @ router.to(acc)                                         # [T,E]
    if pad:
        logits = F.pad(logits, (0, pad), value=float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _experts(x: torch.Tensor, gate_vals: torch.Tensor, le: torch.Tensor, n_local: int, C: int,
             w: Mapping[str, torch.Tensor], gated: bool, local: Optional[torch.Tensor] = None):
    """The dispatch, the experts and the combine of ``n_local`` experts with
    ``C`` slots each. ``le`` [T*k]: each (token, k) assignment's expert
    among them, in the flat (token, k) order; with ``local`` (a mask of the
    assignments to these experts), the others carry ``n_local``, a trash
    class. Returns (out [T,H], load [n_local] int64 (assignments an expert,
    dropped ones too), keep [T*k])."""
    T, H = x.shape
    top_k = gate_vals.shape[1]
    # occupancy before each assignment, per expert; the count runs along the
    # last dim of [E,T*k] (CUDA's scan down the first dim of [T*k,E] runs a
    # thread a column: 203 ms of a granite-moe train step, PERF.md)
    onehot = F.one_hot(le, n_local + (local is not None)).t().contiguous()      # [E(+1),T*k]
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(0, le[None])[0]
    keep = pos < C                                                              # capacity drop
    if local is not None:
        keep = keep & local
    slot = torch.clamp_max(le, n_local - 1) * C + torch.clamp_max(pos, C - 1)  # [T*k]

    x_rep = x.repeat_interleave(top_k, dim=0)                                   # [T*k,H]
    dest = torch.where(keep, slot, n_local * C)                                 # drops: spare row
    buf = x.new_zeros(n_local * C + 1, H).index_copy(0, dest, x_rep)
    he = buf[:-1].view(n_local, C, H)
    if gated:
        inner = F.silu(torch.bmm(he, w["wg"])) * torch.bmm(he, w["wi"])
    else:
        inner = gelu(torch.bmm(he, w["wi"]))
    out_e = torch.bmm(inner, w["wo"]).reshape(n_local * C, H)

    weight = (keep[:, None] * gate_vals.reshape(-1)[:, None]).to(x.dtype)
    out = (out_e[slot] * weight).reshape(T, top_k, H).sum(dim=1)
    return out, onehot[:n_local].sum(dim=1), keep


def moe(x: torch.Tensor, params: Mapping[str, torch.Tensor], top_k: int,
        capacity_factor: float = 1.25, gated: bool = True):
    """``repro.models.layers.moe``: scatter dispatch with a static capacity.
    x [T,H]; params router [H,E], wg/wi [E,H,F], wo [E,F,H]. Returns (out
    [T,H], aux {"load" [E] int64, "drop_fraction", "router_entropy"}).

    The router runs in fp32 (fp64 for fp64 x): softmax, top-k, gates
    renormalised. Each expert keeps C = int(max(1, cf k T / E)) slots, filled
    in the flat (token, k) order; an assignment past its expert's C is
    dropped. The reference adds every assignment into its slot, the dropped
    ones as zeros at slot C - 1; here the kept rows are copied into their
    slots (one writer a slot) and the dropped ones into a spare row that is
    cut off, so the buffer is the same without atomics and with no host sync.
    The experts are batched products in the compute type (the reference
    computes them outside any Pallas kernel), and the combine gathers each
    assignment's slot and weights it by its gate (0 where dropped).

    The experts' SiLU is ``F.silu`` (one rounding in bf16, as XLA fuses the
    reference's ``x * sigmoid(x)``), as in the SSM; see ROADMAP §3."""
    T, H = x.shape
    E = params["router"].shape[1]
    probs, gate_vals, expert_idx = _route(x, params["router"], top_k)
    C = int(max(1, capacity_factor * top_k * T / E))
    out, load, keep = _experts(x, gate_vals, expert_idx.reshape(-1), E, C, params, gated)
    # 1 - mean(keep) as the reference's compiled graph has it: the mean's
    # fp32 reciprocal of T*k times the count, fused into the subtraction
    # (one rounding); a plain fp32 mean differs in the last bit
    recip = torch.tensor(1.0 / keep.numel(), dtype=torch.float32).item()
    aux = {"load": load,
           "drop_fraction": (1.0 - keep.sum(dtype=torch.float64) * recip).to(probs.dtype),
           "router_entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean()}
    return out, aux


def moe_dropless(x: torch.Tensor, params: Mapping[str, torch.Tensor], top_k: int,
                 shared: Optional[Mapping[str, torch.Tensor]] = None):
    """The gated-SiLU MoE layer without a capacity: every assignment runs.
    x [T,H]; params router [H,E], wg/wi [E,H,F], wo [E,F,H]; ``shared``: a
    gated-SiLU MLP's wg/wi [H,Fs], wo [Fs,H] run on every token and added
    (a shared expert). Returns (out [T,H], aux {"load" [E] int64,
    "drop_fraction" 0}).

    The router is ``_route`` (fp32 softmax over the experts, top-k, gates
    renormalised: the softmax over the top-k logits). The T k assignments
    are sorted by expert (a stable sort, so each expert's rows keep the
    (token, k) order); each expert's rows end at its offset, found on the
    device by a search of the sorted experts; the tokens are gathered in
    that order and the experts run as three grouped products
    (``torch._grouped_mm``, expert e on the rows up to its offset, an
    expert with no rows costing nothing; bf16 on the card, fp32 and bf16
    with gradients on the CPU); the rows go back to the (token,
    k) order (one writer a row) and are summed weighted by their gates, as
    ``moe`` combines. Nothing reads a count on the host, so nothing waits
    for the device, except the counters below.

    While a registry is installed (``obs.registry.recording``) the layer
    adds T k to ``host.moe.assignments`` and the experts that got rows to
    ``host.moe.experts_hit`` (one host sync a call)."""
    T, H = x.shape
    E = params["router"].shape[1]
    _, gate_vals, expert_idx = _route(x, params["router"], top_k)
    flat = expert_idx.reshape(-1)                                            # [T*k]
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(flat[order], torch.arange(E, device=x.device), right=True)
    offs = ends.to(torch.int32)
    xs = x[order // top_k]                                                   # [T*k,H], by expert
    inner = (F.silu(torch._grouped_mm(xs, params["wg"], offs=offs))
             * torch._grouped_mm(xs, params["wi"], offs=offs))
    ys = torch.empty_like(xs).index_copy_(0, order, torch._grouped_mm(inner, params["wo"],
                                                                      offs=offs))
    out = (ys.view(T, top_k, H) * gate_vals.to(x.dtype)[..., None]).sum(dim=1)
    if shared is not None:
        out = out + mlp(x, shared, "gated_silu")
    load = torch.diff(ends, prepend=ends.new_zeros(1))
    reg = current()
    if reg:
        reg.counter("host.moe.assignments").inc(T * top_k)
        reg.counter("host.moe.experts_hit").inc(int((load > 0).sum()))
    return out, {"load": load, "drop_fraction": torch.zeros((), dtype=gate_vals.dtype,
                                                            device=x.device)}


def moe_ep(x: torch.Tensor, params: Mapping[str, torch.Tensor], top_k: int, comm,
           capacity_factor: float = 1.25, gated: bool = True, seq: bool = False):
    """``repro.models.layers.moe_ep``: the expert-parallel MoE layer over the
    "model" axis of ``comm`` (a ``parallel.comm.MeshComm``). x [T_l,H]:
    this rank's tokens, the same on every rank of "model" (entered through
    Megatron's f); with ``seq``, [B_l, S/model, H], the sequence shards of
    this rank's rows, gathered here and the output reduce-scattered back.
    ``params``: the layer's router [H,E] and experts wg/wi [E,H,F], wo
    [E,F,H] as DTensors at the planner's placements. Returns (out, the
    shape of x; aux {"load" [E_loc] fp32, "drop_fraction",
    "router_entropy" 0}).

    The experts are padded to E_pad = ceil(E/m) m (m the "model" size), the
    padded router columns masked to -inf. Every rank routes its tokens,
    keeps its E_loc = E_pad/m experts' assignments, C = int(max(1, cf k
    T_l / E_pad)) slots each (``moe``'s dispatch; the rest go to a trash
    class), runs its experts, and one all-reduce over "model" sums the
    partial outputs (a reduce-scatter with ``seq``). A rank's experts are
    its own model shard where the placements put E over "model" (gathered
    over the batch axes only), else gathered whole, padded and cut. The
    router's and those gathered experts' gradients are partial on each
    rank (only its experts' gates and slots reach them).

    The stats are the reference's: ``load`` counts each local expert's
    assignments summed over the batch axes and over "model" at the same
    local index (so its max is not the busiest expert's load), and
    ``drop_fraction`` is 1 - kept / total, total = sum over the ranks of
    T_l k / m."""
    m, r = comm.size, comm.rank
    E = params["router"].shape[1]
    E_pad = -(-E // m) * m
    E_loc = E_pad // m
    h = comm.tp_in(x, seq)
    shape = h.shape
    h = h.reshape(-1, shape[-1])
    T_l = h.shape[0]
    router = comm.weight(params["router"], None, partial=True)
    w = {}
    for name in ("wg", "wi", "wo") if gated else ("wi", "wo"):
        p = params[name]
        if comm.tp_shard(p, 0):
            w[name] = comm.weight(p, 0)                  # this rank's experts, its shard
        else:
            whole = comm.weight(p, None, partial=True)
            if E_pad > E:
                whole = F.pad(whole, (0, 0, 0, 0, 0, E_pad - E))
            w[name] = whole[r * E_loc:(r + 1) * E_loc]
    _, gate_vals, expert_idx = _route(h, router, top_k, E_pad - E)
    C = int(max(1, capacity_factor * top_k * T_l / E_pad))
    flat_e = expert_idx.reshape(-1)
    local = (flat_e >= r * E_loc) & (flat_e < (r + 1) * E_loc)
    le = torch.where(local, flat_e - r * E_loc, E_loc)
    partial, load, keep = _experts(h, gate_vals, le, E_loc, C, w, gated, local)
    out = comm.tp_out(partial.reshape(shape), seq)
    with torch.no_grad():
        stats = torch.cat([load.to(torch.float32), keep.sum(dtype=torch.float32)[None]])
        comm.sum_over_mesh(stats)
    total = T_l * top_k * comm.batch_ranks()       # sum of T_l k over the batch axes and
    aux = {"load": stats[:E_loc],                  # "model", over m
           "drop_fraction": 1.0 - stats[E_loc] / total,
           "router_entropy": torch.zeros((), dtype=torch.float32, device=x.device)}
    return out, aux


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int = 256, initial_state: torch.Tensor | None = None,
             return_state: bool = False):
    """Chunked Mamba2 SSD forward through the SSD kernel.

    x: [B,S,nh,hp]; dt: [B,S,nh] (softplus-ed); A: [nh] (negative);
    Bm/Cm: [B,S,N], shared across heads; initial_state: [B,nh,hp,N] or
    None (zeros). Returns y [B,S,nh,hp] in x's dtype, and with
    ``return_state`` (y, final state [B,nh,hp,N] fp32), as the reference
    does. dt, A and the initial state are taken in fp32, as the reference
    casts them, or in fp64 for an fp64 x, whose plain version computes in
    fp64. The kernel takes strides, so the [B,nh,S,.] views below cost no
    copy and y comes back in x's [B,S,nh,hp] order. ``chunk`` is the plain
    version's chunk length (the kernels block by their own). On the card
    the two state options are served by the bf16 wgmma path only (hp 64,
    N 64 or 128; ``kernels.ssd_scan.kernel_path``). Differentiable in
    every input (``kernels.ssd_scan.SSDScan``)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    init = None if initial_state is None else initial_state.to(acc)
    out = kernels.ssd_scan(x.transpose(1, 2), dt.to(acc).transpose(1, 2), A.to(acc), Bm, Cm,
                           chunk=chunk, initial_state=init, return_state=return_state)
    if return_state:
        y, final = out
        return y.transpose(1, 2), final
    return out.transpose(1, 2)


def ssm_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, state: torch.Tensor):
    """One token of the SSD recurrence (decode), plain PyTorch as in the
    reference. x: [B,nh,hp]; dt: [B,nh]; A: [nh]; Bm/Cm: [B,N]; state:
    [B,nh,hp,N] fp32 -> (y [B,nh,hp] in x's dtype, new state). Computes in
    fp32, or fp64 for an fp64 x."""
    acc = torch.promote_types(x.dtype, torch.float32)
    dtf = dt.to(acc)
    dec = torch.exp(dtf * A.to(acc))                                          # [B,nh]
    upd = torch.einsum("bh,bhp,bn->bhpn", dtf, x.to(acc), Bm.to(acc))
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.to(acc), new_state)
    return y.to(x.dtype), new_state
