"""Sizes and weights of a configuration whose layers are of mixed kinds
(``layer_types``: "mamba" or "attention") and each followed by a dropless
MoE with a shared expert: granite-4.0-h-small.

``sizes.Sizes`` and ``weights.layer_leaves`` know one block kind and no
expert layer; this module gives the leaves of each layer by its kind and
draws each part as ``weights`` does (``weights.draw_part``: one
``torch.randn`` a part from ``traffic.subseed(seed, "weights", i)``, cut
into leaves scaled in place), so the reference can draw any layer again
alone. Leaf names are the port's parameter names.

Scales: a projection N(0, 1/fan_in), the router too; the experts' wg and
wi [E,H,F] N(0, 1/H), their wo [E,F,H] N(0, 1/F). Unlike ``weights``, the
projections back into the residual stream carry no 1/sqrt(2L): the
model's ``residual_multiplier`` scales every sublayer's output instead.
The embedding is N(0, 1/embed_scale^2), so the stream starts at unit RMS
after the embedding multiplier, and the head is the embedding (tied):
the last part holds the final norm alone. Norm weights and ``D`` are
ones, ``conv_b`` zeros, ``A_log`` and ``dt_bias`` as in ``weights``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Tuple

import torch

from .weights import Leaf, draw_part


@dataclass(frozen=True)
class HybridSizes:
    """The ``arch`` group of a configuration file, as the benchmark reads
    it (nothing of the port's config class)."""

    name: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    vocab: int
    layer_types: Tuple[str, ...]
    n_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int
    ssm_state: int
    ssm_headdim: int
    d_inner: int
    conv_width: int
    attn_scale: float
    embed_scale: float
    residual_scale: float
    logit_scale: float
    rope: bool = False
    tie_embeddings: bool = True

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def count(self, kind: str) -> int:
        return sum(t == kind for t in self.layer_types)


def sizes_of(config: Dict) -> HybridSizes:
    arch = config["arch"]
    names = {f.name for f in fields(HybridSizes)}
    sz = HybridSizes(**{k: (tuple(v) if k == "layer_types" else v)
                        for k, v in arch.items() if k in names})
    if sz.rope or not sz.tie_embeddings:
        raise NotImplementedError("the hybrid draw is of NoPE layers and a tied head")
    return sz


def layer_leaves(sz: HybridSizes, kind: str) -> List[Leaf]:
    """One layer's leaves (names within the block): its mixer by ``kind``,
    then the MoE's router, experts and shared expert."""
    H, E, Fe, Fs = sz.d_model, sz.n_experts, sz.d_ff_expert, sz.d_ff_shared
    leaves: List[Leaf] = [("norm1", (H,), "ones", 0.0)]
    if kind == "attention":
        q, kv = sz.n_heads * sz.head_dim, sz.n_kv * sz.head_dim
        leaves += [("attn.wq", (H, q), "normal", H ** -0.5), ("attn.wk", (H, kv), "normal", H ** -0.5),
                   ("attn.wv", (H, kv), "normal", H ** -0.5), ("attn.wo", (q, H), "normal", q ** -0.5)]
    elif kind == "mamba":
        di, N, nh, K = sz.d_inner, sz.ssm_state, sz.ssm_n_heads, sz.conv_width
        leaves += [("ssm.in_proj", (H, 2 * di + 2 * N + nh), "normal", H ** -0.5),
                   ("ssm.conv_w", (K, di + 2 * N), "normal", K ** -0.5),
                   ("ssm.conv_b", (di + 2 * N,), "zeros", 0.0),
                   ("ssm.A_log", (nh,), "A_log", 0.0), ("ssm.D", (nh,), "ones", 0.0),
                   ("ssm.dt_bias", (nh,), "dt_bias", 0.0), ("ssm.ssm_norm", (di,), "ones", 0.0),
                   ("ssm.out_proj", (di, H), "normal", di ** -0.5)]
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    leaves += [("norm2", (H,), "ones", 0.0), ("moe.router", (H, E), "normal", H ** -0.5),
               ("moe.wg", (E, H, Fe), "normal", H ** -0.5), ("moe.wi", (E, H, Fe), "normal", H ** -0.5),
               ("moe.wo", (E, Fe, H), "normal", Fe ** -0.5),
               ("shared.wg", (H, Fs), "normal", H ** -0.5), ("shared.wi", (H, Fs), "normal", H ** -0.5),
               ("shared.wo", (Fs, H), "normal", Fs ** -0.5)]
    return leaves


def parts(sz: HybridSizes) -> List[Tuple[str, int, List[Leaf]]]:
    """(prefix, generator index, leaves) of every part: the embedding
    (index -1), each layer ``i`` and, last, the final norm (index L)."""
    H, L = sz.d_model, sz.num_layers
    out = [("", -1, [("embed", (sz.vocab, H), "normal", 1.0 / sz.embed_scale)])]
    out += [(f"blocks.{i}.", i, layer_leaves(sz, kind)) for i, kind in enumerate(sz.layer_types)]
    out.append(("", L, [("final_norm", (H,), "ones", 0.0)]))
    return out


def draw(sz: HybridSizes, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """The part of generator index ``index``, by full parameter name."""
    for prefix, i, leaves in parts(sz):
        if i == index:
            return {prefix + n: t for n, t in draw_part(leaves, seed, i, device).items()}
    raise KeyError(index)


def expected_shapes(sz: HybridSizes) -> Dict[str, Tuple[int, ...]]:
    return {prefix + n: shape for prefix, _, leaves in parts(sz) for n, shape, _, _ in leaves}


def check_leaves(named: Dict[str, torch.Tensor], sz: HybridSizes) -> None:
    """Raise unless ``named`` holds exactly the leaves drawn here."""
    want = expected_shapes(sz)
    got = {n: tuple(t.shape) for n, t in named.items()}
    if got != want:
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        wrong = sorted(n for n in set(want) & set(got) if want[n] != got[n])
        raise RuntimeError(f"the port's leaves differ from the benchmark's: missing {missing[:5]}, "
                           f"extra {extra[:5]}, other shapes {wrong[:5]}")


@torch.no_grad()
def load_into(named: Dict[str, torch.Tensor], sz: HybridSizes, seed: int) -> None:
    """Draw every part on the tensors' device and copy it into ``named``,
    one part at a time."""
    check_leaves(named, sz)
    device = next(iter(named.values())).device
    for _, index, _ in parts(sz):
        for name, t in draw(sz, seed, index, device).items():
            named[name].copy_(t)
