"""Plain PyTorch versions of the port's kernels (ported from
``repro.kernels.ref``). The wrappers take them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. Layouts
match the kernel entry points: head-major attention, [T,H] rmsnorm,
head-major SSD scan.

``chain_replay_ref`` is the plain version of the simulator's batched chain
replay (``csrc/chain_replay.cu``): the same int32 program walked with torch
ops on (G,) fp64 vectors, each segment's fold an explicit add a row.

``rope_ref`` is the eager rotary embedding of ``repro.models.layers.rope``
past its table, for q and k [B,S,n,hd]; ``rope_bwd_ref`` its gradient in
autograd's order of roundings (held bit for bit against autograd in
``tests/test_torch_rope.py``).

The three backwards (``flash_attention_bwd_ref``, ``rmsnorm_bwd_ref``,
``ssd_scan_bwd_ref``) are written out, not taken from autograd: they are
the math of the CUDA backward kernels, and ``tests/test_torch_grad.py``
holds them against autograd of the forwards here and ``jax.vjp`` of
``repro.kernels.ref``.
The flash backward takes the row log-sum-exp that the forward
(``flash_attention_fwd_ref``, and the forward kernels) returns beside o:
log2 units of the scaled scores, so P = exp2(log2(e) scale q.k - LSE).
Every flash function takes the softmax scale ``scale``; 0 means hd^-0.5.
Everything computes in fp32, or in fp64 for fp64 inputs (gradcheck)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flash_attention_ref", "flash_attention_fwd_ref", "flash_attention_bwd_ref",
           "rmsnorm_ref", "rmsnorm_bwd_ref", "rope_ref", "rope_bwd_ref", "ssd_scan_ref",
           "ssd_scan_bwd_ref", "LOG2E", "chain_replay_ref", "CHAIN_OPS", "np_maximum", "np_minimum"]

LOG2E = 1.4426950408889634       # log2(e): the LSE's units


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def attention_mask(S: int, causal: bool, window: int, device) -> torch.Tensor:
    """[S,S] boolean, True where query row i attends to key column j."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=0.0):
    """q: [B,nh,S,hd]; k,v: [B,nkv,S,hd] -> [B,nh,S,hd]. Naive softmax in fp32."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window, scale=scale)[0]


def flash_attention_fwd_ref(q, k, v, *, causal=True, window=0, scale=0.0):
    """(o, lse): ``flash_attention_ref``'s output and each row's log-sum-exp
    of the scaled, masked scores in log2 units, lse[b,h,i] = log2 sum_j
    exp2(log2(e) scale q_i.k_j) over the live keys j: [B,nh,S] in fp32
    (fp64 for fp64 inputs), -inf for a row with no live key. The forward
    kernels write the same for the backward."""
    return flash_fwd_masked(q, k, v, attention_mask(q.shape[2], causal, window, q.device),
                            scale=scale)


def softmax_scale(hd: int, scale: float = 0.0) -> float:
    """The softmax scale of head dim ``hd``: ``scale``, or hd^-0.5 for 0."""
    return scale if scale else hd ** -0.5


def _masked_scores(q, k, mask, scale=0.0):
    """The grouped q [B,nkv,g,S,hd] and its scaled scores against k with
    masked entries at -inf, [B,nkv,g,S,S], in the compute type."""
    B, nh, S, hd = q.shape
    nkv = k.shape[1]
    acc = _acc(q.dtype)
    qg = q.reshape(B, nkv, nh // nkv, S, hd).to(acc)
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.to(acc)) * softmax_scale(hd, scale)
    return qg, scores.masked_fill(~mask, float("-inf"))


def flash_fwd_masked(q, k, v, mask, scale=0.0):
    """``flash_attention_fwd_ref`` under any [S,S] boolean ``mask`` (True =
    attend): rows with no live key give o = 0 and lse = -inf."""
    B, nh, S, hd = q.shape
    _, scores = _masked_scores(q, k, mask, scale)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)          # fully-masked rows -> 0
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.to(scores.dtype))
    lse = torch.logsumexp(scores, dim=-1) * LOG2E
    return out.reshape(B, nh, S, hd).to(q.dtype), lse.reshape(B, nh, S)


def flash_attention_bwd_ref(q, k, v, o, do, lse=None, *, causal=True, window=0, scale=0.0):
    """The backward of ``flash_attention_ref``: (q, k, v, its output o, the
    gradient do of o, the forward's row log-sum-exp ``lse`` [B,nh,S] in
    log2 units) -> (dq, dk, dv) in the types of q, k, v. FA2's math: P
    recomputed from q, k and lse, D = rowsum(do o), dV = P^T dO,
    dS = P (dO V^T - D), dQ = dS K scale, dK = dS^T Q scale, dK and dV
    summed over the nh / nkv query heads of each kv head. Without ``lse``
    (a caller that has no forward's) it is computed here from q and k."""
    return flash_bwd_masked(q, k, v, o, do, attention_mask(q.shape[2], causal, window, q.device),
                            lse, scale)


def flash_bwd_masked(q, k, v, o, do, mask, lse=None, scale=0.0):
    """``flash_attention_bwd_ref`` under any [S,S] boolean ``mask`` (True =
    attend). Rows with no live key give zero gradients: their log-sum-exp
    is -inf, and every entry is masked before the exp."""
    B, nh, S, hd = q.shape
    nkv = k.shape[1]
    qg, s = _masked_scores(q, k, mask, scale)
    scale = softmax_scale(hd, scale)
    acc = s.dtype
    grp = lambda t: t.reshape(B, nkv, nh // nkv, S, hd).to(acc)
    og, dog = grp(o), grp(do)
    kf, vf = k.to(acc), v.to(acc)
    lse = (torch.logsumexp(s, dim=-1, keepdim=True) * LOG2E if lse is None
           else lse.reshape(B, nkv, nh // nkv, S, 1).to(acc))
    p = torch.exp2((s * LOG2E - lse).masked_fill(~mask, float("-inf")))
    d = (dog * og).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dog)
    ds = p * (torch.einsum("bkgqh,bksh->bkgqs", dog, vf) - d)
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qg) * scale
    return dq.reshape(B, nh, S, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _ssd_chunks(x, dt, A, Bm, Cm, chunk):
    """The SSD inputs in chunks of ``chunk`` tokens, in the compute type,
    the tail padded with zeros (dt = 0 makes a padded token a no-op: it
    leaves the state as it is): xc [B,nh,nc,Q,hp], dtc [B,nh,nc,Q], Bc/Cc
    [B,nc,Q,N], and acs [B,nh,nc,Q], the cumulative log-decay a = dt A
    from each chunk's start."""
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    acc = _acc(x.dtype)
    xc = F.pad(x.to(acc), (0, 0, 0, pad)).reshape(B, nh, nc, Q, hp)
    dtc = F.pad(dt.to(acc), (0, pad)).reshape(B, nh, nc, Q)
    Bc = F.pad(Bm.to(acc), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    Cc = F.pad(Cm.to(acc), (0, 0, 0, pad)).reshape(B, nc, Q, N)
    acs = torch.cumsum(dtc * A.to(acc)[None, :, None, None], dim=-1)
    return xc, dtc, Bc, Cc, acs


def _ssd_decay(acs):
    """L [..., Q, Q]: exp(acs_i - acs_j) for j <= i, else 0, masked before
    exp (acs_i - acs_j > 0 above the diagonal)."""
    Q = acs.shape[-1]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=acs.device).tril()
    return torch.exp((acs[..., :, None] - acs[..., None, :]).masked_fill(~tri, float("-inf")))


def _ssd_entering(states, chunk_decay, initial_state):
    """The state entering each chunk [B,nh,nc,hp,N] and the final state,
    from each chunk's own state update ``states`` [B,nh,nc,hp,N] and decay
    [B,nh,nc]."""
    B, nh, nc, hp, N = states.shape
    h = (torch.zeros(B, nh, hp, N, dtype=states.dtype, device=states.device)
         if initial_state is None else initial_state.to(states.dtype))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, :, c]
    return torch.stack(entering, dim=2), h


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk=256, initial_state=None, return_state=False):
    """Mamba2 SSD scan, chunked (the math of ``repro.models.layers.ssd_scan``
    and of the Pallas kernel). x: [B,nh,S,hp]; dt: [B,nh,S] (softplus-ed);
    A: [nh] (negative); Bm/Cm: [B,S,N], shared across heads -> [B,nh,S,hp]
    in x's dtype, and with ``return_state`` also the final state
    [B,nh,hp,N] in the compute type. The recurrence starts from
    ``initial_state`` ([B,nh,hp,N]) or zeros. Computes in fp32 (fp64 for
    fp64 inputs); the tail is padded with dt = 0, which makes the padded
    tokens no-ops (they leave the state as it is). Vectorised over chunks;
    only the inter-chunk recurrence loops, once per chunk."""
    B, nh, S, hp = x.shape
    xc, dtc, Bc, Cc, acs = _ssd_chunks(x, dt, A, Bm, Cm, chunk)
    nc, Q = dtc.shape[2:]
    # 1) intra-chunk, attention form: C_i.B_j exp(acs_i - acs_j) dt_j for j <= i
    decay = _ssd_decay(acs)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                        # [B,nc,Q,Q]
    scores = cb[:, None] * decay * dtc[..., None, :]                    # [B,nh,nc,Q,Q]
    y = torch.einsum("bhcij,bhcjp->bhcip", scores, xc)
    del decay, scores
    # 2) chunk states: sum_j exp(acs_last - acs_j) dt_j x_j B_j^T
    w = torch.exp(acs[..., -1:] - acs) * dtc
    states = torch.einsum("bhcjp,bcjn->bhcpn", xc * w[..., None], Bc)   # [B,nh,nc,hp,N]
    # 3) inter-chunk recurrence: the state entering each chunk
    h_prev, h = _ssd_entering(states, torch.exp(acs[..., -1]), initial_state)
    # 4) inter-chunk output: (C_i . h_prev) exp(acs_i)
    y = y + torch.einsum("bcin,bhcpn->bhcip", Cc, h_prev) * torch.exp(acs)[..., None]
    y = y.reshape(B, nh, nc * Q, hp)[:, :, :S].to(x.dtype)
    return (y, h) if return_state else y


def _ssd_leaving(dy_c, chunk_decay, d_final):
    """The gradient of the state leaving each chunk [B,nh,nc,hp,N] and the
    gradient of the state entering the first, walking the chunks backward
    from d_final (or zeros), each chunk adding its own ``dy_c``
    [B,nh,nc,hp,N]: g <- decay g + dy_c."""
    B, nh, nc, hp, N = dy_c.shape
    g = (torch.zeros(B, nh, hp, N, dtype=dy_c.dtype, device=dy_c.device) if d_final is None
         else d_final.to(dy_c.dtype))
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = g
        g = g * chunk_decay[:, :, c, None, None] + dy_c[:, :, c]
    return torch.stack(leaving, dim=2), g


def ssd_bwd_segment_walks(states, dy_c, log_decay, initial_state, d_final, seg_chunks):
    """The two state walks of the SSD backward as the wgmma kernel splits
    them (``csrc/ssd_scan_bwd_wgmma.cu``): the chunks cut into segments of
    ``seg_chunks``; each segment's end state from a zero state and the
    gradient reaching its start from a zero gradient; those folded over the
    segments into the state entering each segment (from ``initial_state``)
    and the gradient leaving it (from ``d_final``); then each segment
    walked on its own. ``states`` and ``dy_c`` [B,nh,nc,hp,N] are each
    chunk's own terms, ``log_decay`` [B,nh,nc] its total log-decay. Returns
    (state entering each chunk, gradient of the state leaving each chunk,
    gradient of the initial state), which in exact arithmetic equal the
    serial walks (``_ssd_entering``, ``_ssd_leaving``)."""
    B, nh, nc, hp, N = states.shape
    zero = torch.zeros(B, nh, hp, N, dtype=states.dtype, device=states.device)
    bounds = [(lo, min(nc, lo + seg_chunks)) for lo in range(0, nc, seg_chunks)]
    decay = torch.exp(log_decay)

    def forward(h, lo, hi, keep=None):
        for c in range(lo, hi):
            if keep is not None:
                keep[c] = h
            h = h * decay[:, :, c, None, None] + states[:, :, c]
        return h

    def backward(g, lo, hi, keep=None):
        for c in reversed(range(lo, hi)):
            if keep is not None:
                keep[c] = g
            g = g * decay[:, :, c, None, None] + dy_c[:, :, c]
        return g

    seg_decay = [torch.exp(log_decay[:, :, lo:hi].sum(-1))[..., None, None] for lo, hi in bounds]
    h_in = [zero if initial_state is None else initial_state.to(states.dtype)]
    for s, (lo, hi) in enumerate(bounds[:-1]):
        h_in.append(seg_decay[s] * h_in[-1] + forward(zero, lo, hi))
    d_out = [zero if d_final is None else d_final.to(states.dtype)]
    for s in reversed(range(1, len(bounds))):
        d_out.insert(0, seg_decay[s] * d_out[0] + backward(zero, *bounds[s]))
    entering, leaving = [None] * nc, [None] * nc
    for s, (lo, hi) in enumerate(bounds):
        forward(h_in[s], lo, hi, entering)
        g = backward(d_out[s], lo, hi, leaving)
        if s == 0:
            d_initial = g
    return torch.stack(entering, dim=2), torch.stack(leaving, dim=2), d_initial


def sum_head_groups(t, group):
    """t [B,nh,...] summed over the heads as the wgmma backward sums dB and
    dC: within each group of ``group`` consecutive heads in head order, then
    over the groups in order."""
    parts = []
    for lo in range(0, t.shape[1], group):
        acc = t[:, lo]
        for h in range(lo + 1, min(t.shape[1], lo + group)):
            acc = acc + t[:, h]
        parts.append(acc)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, initial_state=None, d_final=None, *, chunk=256,
                     seg_chunks=None, group=None):
    """The backward of ``ssd_scan_ref``: (its inputs, dy = dL/dy [B,nh,S,hp],
    the forward's ``initial_state`` or None, d_final = dL/d(final state) or
    None) -> (dx, ddt, dA, dBm, dCm, d_initial), each in its input's type,
    d_initial [B,nh,hp,N] in the compute type (the gradient of the state
    the recurrence starts from, zeros or ``initial_state``).

    Per (b, h) and chunk c, with a_j = dt_j A, acs the in-chunk cumsum,
    L_ij = exp(acs_i - acs_j) (j <= i), w_j = exp(acs_last - acs_j) dt_j,
    h_c the state entering chunk c and dh_c' the gradient of the state
    leaving it:
      dh_c = exp(acs_last) dh_c' + sum_i exp(acs_i) dy_i C_i^T  (d_final last);
      dx_j = dt_j sum_{i>=j} (C_i.B_j) L_ij dy_i + w_j dh_c' B_j;
      with G_ij = dy_i.x_j: dC_i = sum_h [sum_j G_ij L_ij dt_j B_j
      + exp(acs_i) h_c^T dy_i], dB_j = sum_h [sum_i G_ij L_ij dt_j C_i
      + w_j dh_c'^T x_j];
      dt_j and a: the direct factor dt_j of the scores and of w_j, and
      d a_m = sum_{k>=m} d acs_k from L, exp(acs_i), w_j and exp(acs_last);
      ddt_j += A d a_j, dA = sum over b and s of dt_j d a_j.
    Padded tail tokens (x = B = C = dt = 0) contribute nothing. Computes in
    fp32, or fp64 for fp64 inputs. ``seg_chunks`` and ``group`` take the
    wgmma kernel's order: the state walks split into segments of that many
    chunks (``ssd_bwd_segment_walks``), dB and dC summed over head groups
    (``sum_head_groups``); by default, serial walks and one einsum over the
    heads."""
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    xc, dtc, Bc, Cc, acs = _ssd_chunks(x, dt, A, Bm, Cm, chunk)
    nc, Q = dtc.shape[2:]
    acc = xc.dtype
    dyc = F.pad(dy.to(acc), (0, 0, 0, nc * Q - S)).reshape(B, nh, nc, Q, hp)
    decay = _ssd_decay(acs)                                    # L [B,nh,nc,Q,Q]
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None]      # C_i.B_j [B,1,nc,Q,Q]
    ea = torch.exp(acs)                                        # exp(acs_i)
    chunk_decay = torch.exp(acs[..., -1])                      # [B,nh,nc]
    el = torch.exp(acs[..., -1:] - acs)                        # exp(acs_last - acs_j)
    w = el * dtc
    # the state entering each chunk (forward), then the gradient of the
    # state leaving each chunk (reverse)
    states = torch.einsum("bhcjp,bcjn->bhcpn", xc * w[..., None], Bc)
    dy_c = torch.einsum("bhcip,bcin->bhcpn", dyc * ea[..., None], Cc)
    if seg_chunks is None:
        h_prev, _ = _ssd_entering(states, chunk_decay, initial_state)
        dh, d_initial = _ssd_leaving(dy_c, chunk_decay, d_final)    # dh [B,nh,nc,hp,N]
    else:
        h_prev, dh, d_initial = ssd_bwd_segment_walks(states, dy_c, acs[..., -1], initial_state,
                                                      d_final, seg_chunks)
    del states, dy_c
    # intra-chunk products
    G = torch.einsum("bhcip,bhcjp->bhcij", dyc, xc)            # dy_i.x_j
    ldt = decay * dtc[..., None, :]                            # L_ij dt_j
    dx = torch.einsum("bhcij,bhcip->bhcjp", cb * ldt, dyc)
    T = G * ldt
    E = G * cb * decay                                         # d score_ij / d dt_j, times G
    del ldt, decay, G
    r = torch.einsum("bhcpn,bcjn->bhcjp", dh, Bc)              # dh_c' B_j
    dx = dx + w[..., None] * r
    u = torch.einsum("bhcpn,bhcip->bhcin", h_prev, dyc)        # h_c^T dy_i
    v = torch.einsum("bhcpn,bhcjp->bhcjn", dh, xc)             # dh_c'^T x_j
    if group is None:
        dC = torch.einsum("bhcij,bcjn->bcin", T, Bc) + torch.einsum("bhci,bhcin->bcin", ea, u)
        dB = torch.einsum("bhcij,bcin->bcjn", T, Cc) + torch.einsum("bhcj,bhcjn->bcjn", w, v)
    else:
        dC = sum_head_groups(ea[..., None] * u + torch.einsum("bhcij,bcjn->bhcin", T, Bc), group)
        dB = sum_head_groups(w[..., None] * v + torch.einsum("bhcij,bcin->bhcjn", T, Cc), group)
    del T
    bv = (Bc[:, None] * v).sum(-1)                             # x_j.(dh_c' B_j)
    col = E.sum(-2)                                            # sum_i E_ij
    # d a_m = sum_{k>=m} d acs_k, summed where each term lands: the scores
    # whose pair (i, j) straddles m (i >= m > j), exp(acs_i) for i >= m, w_j
    # for j < m, and exp(acs_last). The same sum taken as a reverse cumsum of
    # d acs cancels row and column sums of the scores and loses digits.
    mask = (torch.arange(Q, device=x.device)[:, None]
            >= torch.arange(Q, device=x.device)[None, :])     # [i, m]: i >= m
    before = F.pad(torch.cumsum(E * dtc[..., None, :], dim=-1)[..., :-1], (1, 0))  # sum_{j<m}
    da = ((before * mask).sum(-2)
          + torch.flip(torch.cumsum(torch.flip(ea * (Cc[:, None] * u).sum(-1), [-1]), -1), [-1])
          + F.pad(torch.cumsum(w * bv, dim=-1)[..., :-1], (1, 0))
          + (chunk_decay * (dh * h_prev).sum((-1, -2)))[..., None])
    ddt = col + el * bv + A.to(acc)[None, :, None, None] * da
    dA = (dtc * da).sum((0, 2, 3))
    dx = dx.reshape(B, nh, nc * Q, hp)[:, :, :S]
    ddt = ddt.reshape(B, nh, nc * Q)[:, :, :S]
    dB, dC = (t.reshape(B, nc * Q, N)[:, :S] for t in (dB, dC))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype),
            d_initial)


def rmsnorm_ref(x, w, eps=1e-5):
    """x: [T,H]; w: [H]. Multiplies by w in fp32, then casts (as the kernel)."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(acc)[None, :]).to(x.dtype)


def rmsnorm_bwd_ref(x, w, dy, eps=1e-5):
    """The backward of ``rmsnorm_ref``: (x [T,H], w [H], dy [T,H]) -> (dx in
    x's type, dw in w's type). With r = rsqrt(mean(x^2) + eps) per row:
    dx = r (w dy) - x r^3 mean(x w dy), dw = sum over rows of dy x r."""
    acc = _acc(x.dtype)
    xf, wf, dyf = x.to(acc), w.to(acc)[None, :], dy.to(acc)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    c = (xf * wf * dyf).mean(dim=-1, keepdim=True)
    dx = r * (wf * dyf) - xf * (r * r * r) * c
    dw = (dyf * xf * r).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _rotate(x, cos, sin):
    """``repro.models.layers.rope`` past its table: x [B,S,n,hd], cos and
    sin [B,S,hd/2] fp32."""
    half = x.shape[-1] // 2
    cos, sin = cos[..., :, None, :], sin[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_ref(q, k, cos, sin):
    """Rotary embedding of q [B,S,nh,hd] and k [B,S,nkv,hd] by the table
    cos, sin [B,S,hd/2] (fp32): each half's products with the table in
    fp32 (fp64 for fp64), their difference and sum, one cast to x's type.
    Returns (q, k) rotated."""
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def _unrotate(g, cos, sin):
    """The gradient of ``_rotate`` in autograd's order: g widened to the
    forward's product type, each product cast to g's type, the two of a
    half summed in g's type; adding 0 turns a -0 into +0, as autograd's
    sum of the two halves' zero-padded slice gradients does."""
    half = g.shape[-1] // 2
    cos, sin = cos[..., :, None, :], sin[..., :, None, :]
    acc, dt = _acc(g.dtype), g.dtype
    g1, g2 = g[..., :half].to(acc), g[..., half:].to(acc)
    d1 = (g1 * cos).to(dt) + (g2 * sin).to(dt)
    d2 = (g2 * cos).to(dt) - (g1 * sin).to(dt)
    return torch.cat([d1, d2], dim=-1) + 0


def rope_bwd_ref(gq, gk, cos, sin):
    """The backward of ``rope_ref``: (dq, dk) from the outputs' gradients,
    dx1 = g1 c + g2 s and dx2 = g2 c - g1 s, bit for bit autograd's."""
    return _unrotate(gq, cos, sin), _unrotate(gk, cos, sin)


# opcodes of a chain program (csrc/chain_replay.cu reads the same numbers)
CHAIN_OPS = {"seg": 0, "par": 1, "branch_end": 2, "par_end": 3, "spawn": 4, "spawn_end": 5,
             "end": 6}
_SEG, _PAR, _BRANCH_END, _PAR_END, _SPAWN, _SPAWN_END, _END = range(7)


def np_maximum(a, b):
    """``np.maximum`` elementwise: ``a`` where ``a >= b`` or ``a`` is NaN,
    else ``b`` (so a NaN in either propagates)."""
    return torch.where((a >= b) | torch.isnan(a), a, b)


def np_minimum(a, b):
    """``np.minimum`` elementwise, NaN-propagating as ``np_maximum``."""
    return torch.where((a <= b) | torch.isnan(a), a, b)


def chain_replay_ref(code, V, t, accs, entry, holds, spawns, depth):
    """Run the chain program at ``code[entry:]`` for every column of the
    leaf matrix ``V`` [rows, G] (fp64) from the times ``t`` [G]. Returns
    (end time [G], hold starts [holds, G], hold ends [holds, G], spawn ends
    [spawns, G]) and adds the byte counters into ``accs`` [3, G] in place.
    ``depth`` (the deepest par/spawn nesting) sizes the kernel's stack and
    is not needed here. Every time is the left fold ``t = t + V[row]``, one
    row at a time, never a reassociating ``cumsum``."""
    prog = code.tolist()
    t = t.clone()                   # an op's output may not alias its input
    G = V.shape[1]
    hold_start = V.new_empty((holds, G))
    hold_end = V.new_empty((holds, G))
    spawn_end = V.new_empty((spawns, G))
    stack = []                      # [start time, best so far or None]
    n_hold = n_spawn = 0
    pc = entry
    while True:
        op = prog[pc]
        if op == _SEG:
            k, h, n0, n1, n2 = prog[pc + 1:pc + 6]
            adv = prog[pc + 6:pc + 6 + k]
            pos = prog[pc + 6 + k:pc + 6 + k + h]
            j = 0
            for i, row in enumerate(adv):
                prev = t
                t = t + V[row]
                while j < h and pos[j] == i:
                    hold_start[n_hold] = prev
                    hold_end[n_hold] = t
                    n_hold += 1
                    j += 1
            at = pc + 6 + k + h
            for a, n in enumerate((n0, n1, n2)):
                for row in prog[at:at + n]:
                    accs[a] += V[row]
                at += n
            pc = at
        elif op in (_PAR, _SPAWN):
            stack.append([t, None])
            pc += 1
        elif op == _BRANCH_END:
            frame = stack[-1]
            frame[1] = t if frame[1] is None else np_maximum(frame[1], t)
            t = frame[0]
            pc += 1
        elif op == _PAR_END:
            best = stack.pop()[1]
            if best is not None:
                t = best
            pc += 1
        elif op == _SPAWN_END:
            spawn_end[n_spawn] = t
            n_spawn += 1
            t = stack.pop()[0]
            pc += 1
        elif op == _END:
            return t, hold_start, hold_end, spawn_end
        else:
            raise ValueError(f"chain program: unknown opcode {op} at word {pc}")
