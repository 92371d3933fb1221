"""The weights of a run, drawn on the device from ``--seed``.

Each layer, the embedding and the head draws from a generator of its own
(``traffic.subseed(seed, "weights", i)``): one ``torch.randn`` over all of
the part's elements in fp32, cut into leaves that are scaled in place, so
the reference can draw any one part again alone and get the same values.
Norm weights and ``D`` are ones and ``conv_b`` zeros; ``A_log`` and
``dt_bias`` take their uniform draws from the same normal numbers through
the normal CDF (Mamba-2's init: A = U(1, 16), dt = exp U(log 1e-3,
log 1e-1), dt_bias its inverse softplus).

Scales: a projection N(0, 1/fan_in), the projections back into the
residual stream (attention's ``wo``, the MLP's ``wo``, ``out_proj``) also
over sqrt(2 L); the embedding N(0, 1), the head N(0, 1/H), the depthwise
conv N(0, 1/K). Leaf names are the port's parameter names, so a run
checks that the port holds exactly these leaves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .traffic import generator

Leaf = Tuple[str, Tuple[int, ...], str, float]   # name, shape, init, std


def layer_leaves(arch) -> List[Leaf]:
    """One block's leaves (names within the block)."""
    H, L = arch.d_model, arch.num_layers
    out = (2 * L) ** -0.5
    leaves: List[Leaf] = [("norm1", (H,), "ones", 0.0)]
    if arch.has_attention:
        q, kv = arch.n_heads * arch.head_dim, arch.n_kv * arch.head_dim
        leaves += [("attn.wq", (H, q), "normal", H ** -0.5), ("attn.wk", (H, kv), "normal", H ** -0.5),
                   ("attn.wv", (H, kv), "normal", H ** -0.5),
                   ("attn.wo", (q, H), "normal", q ** -0.5 * out)]
    if arch.block in ("ssm", "hymba"):
        di, N, nh, K = arch.d_inner, arch.ssm_state, arch.ssm_n_heads, arch.conv_width
        leaves += [("ssm.in_proj", (H, 2 * di + 2 * N + nh), "normal", H ** -0.5),
                   ("ssm.conv_w", (K, di + 2 * N), "normal", K ** -0.5),
                   ("ssm.conv_b", (di + 2 * N,), "zeros", 0.0),
                   ("ssm.A_log", (nh,), "A_log", 0.0), ("ssm.D", (nh,), "ones", 0.0),
                   ("ssm.dt_bias", (nh,), "dt_bias", 0.0), ("ssm.ssm_norm", (di,), "ones", 0.0),
                   ("ssm.out_proj", (di, H), "normal", di ** -0.5 * out)]
    if arch.has_attention and arch.d_ff:
        if arch.n_experts:
            raise NotImplementedError("expert layers have no draw here yet")
        F = arch.d_ff
        leaves.append(("norm2", (H,), "ones", 0.0))
        if arch.mlp == "gated_silu":
            leaves.append(("mlp.wg", (H, F), "normal", H ** -0.5))
        leaves += [("mlp.wi", (H, F), "normal", H ** -0.5), ("mlp.wo", (F, H), "normal", F ** -0.5 * out)]
    return leaves


def parts(arch) -> List[Tuple[str, int, List[Leaf]]]:
    """(prefix, generator index, leaves) of every part: the embedding
    (index -1, with no embedding for an arch fed embeddings), each block
    ``i`` and, last, the final norm and the head (index L)."""
    H, V, L = arch.d_model, arch.vocab, arch.num_layers
    out = [] if arch.embeds_input else [("", -1, [("embed", (V, H), "normal", 1.0)])]
    out += [(f"blocks.{i}.", i, layer_leaves(arch)) for i in range(L)]
    out.append(("", L, [("final_norm", (H,), "ones", 0.0), ("lm_head", (H, V), "normal", H ** -0.5)]))
    return out


def _fill(t: torch.Tensor, init: str, std: float) -> None:
    if init == "normal":
        t.mul_(std)
    elif init == "ones":
        t.fill_(1.0)
    elif init == "zeros":
        t.zero_()
    elif init == "A_log":
        t.copy_(torch.log(1.0 + 15.0 * torch.special.ndtr(t)))
    elif init == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * torch.special.ndtr(t))
        t.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(f"unknown init {init!r}")


def draw_part(leaves: List[Leaf], seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """One part's leaves in fp32, views of one buffer drawn in one call."""
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, "weights", index),
                       dtype=torch.float32, device=device)
    out = {}
    for (name, shape, init, std), t in zip(leaves, flat.split(sizes)):
        t = t.view(shape)
        _fill(t, init, std)
        out[name] = t
    return out


def draw(arch, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """The part of generator index ``index`` (see ``parts``), by full
    parameter name."""
    for prefix, i, leaves in parts(arch):
        if i == index:
            return {prefix + n: t for n, t in draw_part(leaves, seed, i, device).items()}
    raise KeyError(index)


def expected_shapes(arch) -> Dict[str, Tuple[int, ...]]:
    return {prefix + n: shape for prefix, _, leaves in parts(arch) for n, shape, _, _ in leaves}


def check_leaves(named: Dict[str, torch.Tensor], arch) -> None:
    """Raise unless ``named`` holds exactly the leaves drawn here, with
    their shapes."""
    want = expected_shapes(arch)
    got = {n: tuple(t.shape) for n, t in named.items()}
    if got != want:
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        wrong = sorted(n for n in set(want) & set(got) if want[n] != got[n])
        raise RuntimeError(f"the port's leaves differ from the benchmark's: missing {missing[:5]}, "
                           f"extra {extra[:5]}, other shapes {wrong[:5]}")


@torch.no_grad()
def load_into(named: Dict[str, torch.Tensor], arch, seed: int) -> None:
    """Draw every part on the tensors' device and copy it into ``named``
    (parameter name -> tensor, any dtype), one part at a time."""
    check_leaves(named, arch)
    device = next(iter(named.values())).device
    for _, index, _ in parts(arch):
        for name, t in draw(arch, seed, index, device).items():
            named[name].copy_(t)


def copy_sample(seed: int, name: str, numel: int, device, k: int = 1 << 16) -> torch.Tensor:
    """The flat indices of leaf ``name`` at which the compute copy is
    checked: ``k`` drawn from the seed (all of a smaller leaf)."""
    if numel <= k:
        return torch.arange(numel, device=device)
    return torch.randint(0, numel, (k,), generator=generator(device, seed, "copy", name),
                         device=device)


@torch.no_grad()
def masters(arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf in fp32, drawn in place: each part's buffer is the
    storage of its leaves."""
    out = {}
    for _, index, _ in parts(arch):
        out.update(draw(arch, seed, index, device))
    return out
