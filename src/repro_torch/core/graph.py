"""Workload IR: operator computation graph (PALM §IV-B, Table III).

PALM consumes a computation graph of operators; each operator knows its
FLOPs, parameter count and activation sizes, and (in ``parallelism.py``)
how collective-communication volume scales with its parallelism degrees.

The paper's Table III defines Linear / Conv2 / Pool / Transformer. The
paper treats a transformer as "a combination of a series of linear
operators" — we follow the same decomposition rule to add the operator
types our assigned architectures need: ``Attention`` (GQA, optional
sliding window, decode mode), ``MoE`` (top-k experts), ``SSMScan``
(Mamba2 SSD), ``Embedding`` and ``Norm``.

All sizes are stored in *elements*; byte counts are ``elems *
precision_bytes`` where precision comes from the hardware/parallelism
context. All FLOPs are forward-pass; backward defaults to 2x forward for
weighted (matmul) operators and 1x for unweighted ones, the standard
accounting also used by Megatron.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Op",
    "Linear",
    "Conv2",
    "Pool",
    "TransformerLayer",
    "Attention",
    "MoELayer",
    "SSMScan",
    "Embedding",
    "Norm",
    "ComputationGraph",
    "transformer_lm_graph",
    "resnet50_graph",
    "bert_base_graph",
]


@dataclass
class Op:
    """Base operator. Subclasses fill in the cost accounting."""

    name: str

    # -- costs (full, unsplit) ---------------------------------------------
    def fwd_flops(self) -> float:
        raise NotImplementedError

    def bwd_flops(self) -> float:
        return (2.0 if self.param_count() > 0 else 1.0) * self.fwd_flops()

    def param_count(self) -> float:
        return 0.0

    def in_elems(self) -> float:
        """Input activation element count (Alg. 1 ``Op.I``)."""
        raise NotImplementedError

    def out_elems(self) -> float:
        """Output activation element count (Alg. 1 ``Op.O``)."""
        raise NotImplementedError

    @property
    def matmul_fraction(self) -> float:
        """Fraction of FLOPs that run on the matrix unit (vs vector unit)."""
        return 1.0 if self.param_count() > 0 else 0.0

    # -- helpers --------------------------------------------------------------
    def flops_total(self, training: bool = True) -> float:
        return self.fwd_flops() + (self.bwd_flops() if training else 0.0)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name} {self.fwd_flops():.3g}F {self.param_count():.3g}P>"


# ---------------------------------------------------------------------------
# Table III operators
# ---------------------------------------------------------------------------

@dataclass
class Linear(Op):
    """Y = W X^T with X:(N,K), W:(M,K), Y:(M,N), batched B (Table III row 1)."""

    B: int = 1
    M: int = 1
    N: int = 1
    K: int = 1

    def fwd_flops(self) -> float:
        return 2.0 * self.B * self.M * self.N * self.K

    def param_count(self) -> float:
        return float(self.M * self.K)

    def in_elems(self) -> float:
        return float(self.B * self.N * self.K)

    def out_elems(self) -> float:
        return float(self.B * self.M * self.N)


@dataclass
class Conv2(Op):
    """Conv2D, input (B,C,I,I), weight (R,S,C,K), output (B,K,O,O)."""

    B: int = 1
    H: int = 1
    W: int = 1
    C: int = 1
    R: int = 1
    S: int = 1
    K: int = 1
    stride: int = 1

    @property
    def H_out(self) -> int:
        return max(1, self.H // self.stride)

    @property
    def W_out(self) -> int:
        return max(1, self.W // self.stride)

    def fwd_flops(self) -> float:
        return 2.0 * self.B * self.H_out * self.W_out * self.R * self.S * self.C * self.K

    def param_count(self) -> float:
        return float(self.R * self.S * self.C * self.K)

    def in_elems(self) -> float:
        return float(self.B * self.C * self.H * self.W)

    def out_elems(self) -> float:
        return float(self.B * self.K * self.H_out * self.W_out)


@dataclass
class Pool(Op):
    """Pooling, window RxS (Table III row 3; K == 1)."""

    B: int = 1
    H: int = 1
    W: int = 1
    C: int = 1
    R: int = 2
    S: int = 2
    stride: int = 2

    def fwd_flops(self) -> float:
        return 2.0 * self.B * self.H * self.W * self.R * self.S * self.C / (self.stride ** 2)

    def in_elems(self) -> float:
        return float(self.B * self.C * self.H * self.W)

    def out_elems(self) -> float:
        return float(self.B * self.C * (self.H // self.stride) * (self.W // self.stride))


# ---------------------------------------------------------------------------
# Transformer-family operators (paper row 4 + our extensions)
# ---------------------------------------------------------------------------

@dataclass
class TransformerLayer(Op):
    """One decoder/encoder layer, Megatron accounting (Table III row 4).

    Generalises the paper's [B,S,H] row with GQA (``n_kv < n_heads``),
    gated MLPs, squared-ReLU, and sliding-window attention. With
    ``n_kv == n_heads``, gate off and ``d_ff = 4H`` the FLOPs reduce to the
    paper's ``24BSH^2 + 4BS^2H``.
    """

    B: int = 1
    S: int = 1
    H: int = 1              # d_model
    n_heads: int = 1
    n_kv: int = 1
    d_head: int = 0         # defaults to H / n_heads
    d_ff: int = 1
    gated_mlp: bool = True
    causal: bool = True
    window: Optional[int] = None   # sliding-window attention span

    def __post_init__(self):
        if self.d_head == 0:
            self.d_head = self.H // max(1, self.n_heads)

    # decomposition --------------------------------------------------------
    @property
    def attn_span(self) -> float:
        span = float(self.S if self.window is None else min(self.window, self.S))
        if self.causal and self.window is None:
            span = self.S / 2.0  # causal mask halves the score work
        return span

    def qkv_flops(self) -> float:
        q = self.n_heads * self.d_head
        kv = 2 * self.n_kv * self.d_head
        return 2.0 * self.B * self.S * self.H * (q + kv)

    def score_flops(self) -> float:
        # QK^T and PV, span-limited
        return 4.0 * self.B * self.S * self.attn_span * self.n_heads * self.d_head

    def out_proj_flops(self) -> float:
        return 2.0 * self.B * self.S * (self.n_heads * self.d_head) * self.H

    def mlp_flops(self) -> float:
        mults = 3 if self.gated_mlp else 2
        return 2.0 * self.B * self.S * self.H * self.d_ff * mults

    def fwd_flops(self) -> float:
        return self.qkv_flops() + self.score_flops() + self.out_proj_flops() + self.mlp_flops()

    def param_count(self) -> float:
        attn = self.H * (self.n_heads + 2 * self.n_kv) * self.d_head + (self.n_heads * self.d_head) * self.H
        mlp = (3 if self.gated_mlp else 2) * self.H * self.d_ff
        return float(attn + mlp + 2 * self.H)  # + two norms

    def in_elems(self) -> float:
        return float(self.B * self.S * self.H)

    def out_elems(self) -> float:
        return float(self.B * self.S * self.H)

    @property
    def matmul_fraction(self) -> float:
        f = self.fwd_flops()
        return (f - 0.0) / f if f else 1.0


@dataclass
class Attention(Op):
    """Standalone attention (used for decode: S_q new tokens vs S_kv cache)."""

    B: int = 1
    S_q: int = 1
    S_kv: int = 1
    n_heads: int = 1
    n_kv: int = 1
    d_head: int = 64

    def fwd_flops(self) -> float:
        return 4.0 * self.B * self.S_q * self.S_kv * self.n_heads * self.d_head

    def in_elems(self) -> float:
        # query + cached K/V
        return float(self.B * (self.S_q * self.n_heads + 2 * self.S_kv * self.n_kv) * self.d_head)

    def out_elems(self) -> float:
        return float(self.B * self.S_q * self.n_heads * self.d_head)

    @property
    def matmul_fraction(self) -> float:
        return 0.85


@dataclass
class MoELayer(Op):
    """Mixture-of-experts FFN with top-k routing (DBRX / granite-moe)."""

    B: int = 1
    S: int = 1
    H: int = 1
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 1
    gated_mlp: bool = True

    def router_flops(self) -> float:
        return 2.0 * self.B * self.S * self.H * self.n_experts

    def expert_flops(self) -> float:
        mults = 3 if self.gated_mlp else 2
        return 2.0 * self.B * self.S * self.top_k * self.H * self.d_ff_expert * mults

    def fwd_flops(self) -> float:
        return self.router_flops() + self.expert_flops()

    def param_count(self) -> float:
        mults = 3 if self.gated_mlp else 2
        return float(self.n_experts * mults * self.H * self.d_ff_expert + self.H * self.n_experts)

    def in_elems(self) -> float:
        return float(self.B * self.S * self.H)

    def out_elems(self) -> float:
        return float(self.B * self.S * self.H)


@dataclass
class SSMScan(Op):
    """Mamba2 SSD block: in/out projections + chunked state-space scan."""

    B: int = 1
    S: int = 1
    H: int = 1              # d_model
    d_inner: int = 0        # typically 2H
    d_state: int = 128
    n_heads: int = 0        # SSD heads; d_inner / headdim
    conv_width: int = 4

    def __post_init__(self):
        if self.d_inner == 0:
            self.d_inner = 2 * self.H
        if self.n_heads == 0:
            self.n_heads = max(1, self.d_inner // 64)

    def proj_flops(self) -> float:
        # in_proj produces x, z, B, C, dt; out_proj back to H
        d_in_proj = 2 * self.d_inner + 2 * self.d_state + self.n_heads
        return 2.0 * self.B * self.S * self.H * d_in_proj + 2.0 * self.B * self.S * self.d_inner * self.H

    def scan_flops(self) -> float:
        # SSD recurrence: state update + output read, ~6 flops per
        # (token, channel, state) plus depthwise conv
        return 6.0 * self.B * self.S * self.d_inner * self.d_state + \
            2.0 * self.B * self.S * self.d_inner * self.conv_width

    def fwd_flops(self) -> float:
        return self.proj_flops() + self.scan_flops()

    def param_count(self) -> float:
        d_in_proj = 2 * self.d_inner + 2 * self.d_state + self.n_heads
        return float(self.H * d_in_proj + self.d_inner * self.H +
                     self.d_inner * self.conv_width + 2 * self.n_heads)

    def in_elems(self) -> float:
        return float(self.B * self.S * self.H)

    def out_elems(self) -> float:
        return float(self.B * self.S * self.H)

    @property
    def matmul_fraction(self) -> float:
        f = self.fwd_flops()
        return self.proj_flops() / f if f else 1.0


@dataclass
class Embedding(Op):
    """Token embedding lookup (DRAM-traffic-dominant for 256k vocabs)."""

    B: int = 1
    S: int = 1
    H: int = 1
    V: int = 1

    def fwd_flops(self) -> float:
        return float(self.B * self.S * self.H)  # gather + scale

    def bwd_flops(self) -> float:
        return float(self.B * self.S * self.H)  # scatter-add

    def param_count(self) -> float:
        return float(self.V * self.H)

    def in_elems(self) -> float:
        return float(self.B * self.S)

    def out_elems(self) -> float:
        return float(self.B * self.S * self.H)

    @property
    def matmul_fraction(self) -> float:
        return 0.0


@dataclass
class Norm(Op):
    """RMSNorm / LayerNorm (vector op)."""

    B: int = 1
    S: int = 1
    H: int = 1

    def fwd_flops(self) -> float:
        return 5.0 * self.B * self.S * self.H

    def param_count(self) -> float:
        return float(self.H)

    def in_elems(self) -> float:
        return float(self.B * self.S * self.H)

    def out_elems(self) -> float:
        return float(self.B * self.S * self.H)

    @property
    def matmul_fraction(self) -> float:
        return 0.0


# ---------------------------------------------------------------------------
# Graph container
# ---------------------------------------------------------------------------

@dataclass
class ComputationGraph:
    """Operator list + dependency edges (indices into ``ops``).

    A linear chain (the common LM case) needs no explicit edges; ops
    without edges depend on their predecessor, matching the paper's
    "pre-order rule" for dependency-free operators.
    """

    ops: List[Op]
    edges: List[Tuple[int, int]] = field(default_factory=list)
    name: str = "graph"

    def __post_init__(self):
        if not self.edges and len(self.ops) > 1:
            self.edges = [(i, i + 1) for i in range(len(self.ops) - 1)]

    def __len__(self) -> int:
        return len(self.ops)

    def total_fwd_flops(self) -> float:
        return sum(op.fwd_flops() for op in self.ops)

    def total_params(self) -> float:
        return sum(op.param_count() for op in self.ops)

    def successors(self, i: int) -> List[int]:
        return [d for (s, d) in self.edges if s == i]

    def predecessors(self, i: int) -> List[int]:
        return [s for (s, d) in self.edges if d == i]

    def partition_stages(self, num_stages: int) -> List[List[int]]:
        """Default stage allocation "based on computing power requirements"
        (paper §IV-B ❶): contiguous split balancing fwd+bwd FLOPs against
        cumulative targets; every stage receives at least one op."""
        if num_stages > len(self.ops):
            raise ValueError(
                f"{num_stages} stages > {len(self.ops)} ops in {self.name!r}")
        flops = [op.flops_total() for op in self.ops]
        total = sum(flops)
        stages: List[List[int]] = [[] for _ in range(num_stages)]
        s, acc = 0, 0.0
        for i, f in enumerate(flops):
            ops_left = len(flops) - i
            stages_left = num_stages - s
            over_target = acc + f / 2 > total * (s + 1) / num_stages
            must_advance = ops_left <= stages_left  # 1 op per remaining stage
            if stages[s] and stages_left > 1 and (over_target or must_advance):
                s += 1
            stages[s].append(i)
            acc += f
        return stages


# ---------------------------------------------------------------------------
# Graph builders for the paper's case studies
# ---------------------------------------------------------------------------

def transformer_lm_graph(
    name: str,
    num_layers: int,
    d_model: int,
    n_heads: int,
    seq_len: int,
    batch: int,
    vocab: int = 51200,
    n_kv: Optional[int] = None,
    d_ff: Optional[int] = None,
    gated_mlp: bool = False,
    include_embedding: bool = True,
) -> ComputationGraph:
    """GPT-style LM as PALM sees it: Embedding + L x TransformerLayer + LMHead."""
    n_kv = n_heads if n_kv is None else n_kv
    d_ff = 4 * d_model if d_ff is None else d_ff
    ops: List[Op] = []
    if include_embedding:
        ops.append(Embedding(name="embed", B=batch, S=seq_len, H=d_model, V=vocab))
    for i in range(num_layers):
        ops.append(TransformerLayer(
            name=f"layer{i}", B=batch, S=seq_len, H=d_model, n_heads=n_heads,
            n_kv=n_kv, d_ff=d_ff, gated_mlp=gated_mlp, causal=True))
    if include_embedding:
        ops.append(Linear(name="lm_head", B=batch, M=vocab, N=seq_len, K=d_model))
    return ComputationGraph(ops=ops, name=name)


def resnet50_graph(batch: int, image: int = 224) -> ComputationGraph:
    """ResNet-50 (He et al. [1]) for the Grayskull Table V benchmark."""
    ops: List[Op] = [Conv2(name="stem", B=batch, H=image, W=image, C=3, R=7, S=7, K=64, stride=2)]
    ops.append(Pool(name="maxpool", B=batch, H=image // 2, W=image // 2, C=64, R=3, S=3, stride=2))

    def bottleneck(idx: int, hw: int, cin: int, cmid: int, cout: int, stride: int):
        ops.append(Conv2(name=f"b{idx}_1x1a", B=batch, H=hw, W=hw, C=cin, R=1, S=1, K=cmid, stride=1))
        ops.append(Conv2(name=f"b{idx}_3x3", B=batch, H=hw, W=hw, C=cmid, R=3, S=3, K=cmid, stride=stride))
        ops.append(Conv2(name=f"b{idx}_1x1b", B=batch, H=hw // stride, W=hw // stride, C=cmid, R=1, S=1, K=cout, stride=1))

    idx = 0
    hw = image // 4
    spec = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2)]
    cin = 64
    for blocks, cmid, cout, first_stride in spec:
        for b in range(blocks):
            stride = first_stride if b == 0 else 1
            bottleneck(idx, hw, cin, cmid, cout, stride)
            hw //= stride
            cin = cout
            idx += 1
    ops.append(Pool(name="avgpool", B=batch, H=hw, W=hw, C=2048, R=hw, S=hw, stride=max(1, hw)))
    ops.append(Linear(name="fc", B=batch, M=1000, N=1, K=2048))
    return ComputationGraph(ops=ops, name="resnet50")


def bert_base_graph(batch: int, seq_len: int = 128) -> ComputationGraph:
    """BERT-base (12L, H=768) for Table V / Fig. 12 benchmarks."""
    ops: List[Op] = [Embedding(name="embed", B=batch, S=seq_len, H=768, V=30522)]
    for i in range(12):
        ops.append(TransformerLayer(
            name=f"layer{i}", B=batch, S=seq_len, H=768, n_heads=12, n_kv=12,
            d_ff=3072, gated_mlp=False, causal=False))
    return ComputationGraph(ops=ops, name="bert_base")
