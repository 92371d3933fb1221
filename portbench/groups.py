"""Device kernels by group, from their names: a copy of
``scripts/train_step_profile.py``'s ``GROUPS`` (matched in order, lower
case: the first key in a kernel's name names its group), and which of the
port's kernels (``repro_torch.kernels.launch_counts`` names) each group of
the port's own kernels belongs to."""

from __future__ import annotations

GROUPS = (("ssd_cb_kernel<128, true>", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb_kernel<64, true>", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb_kernelili128elb1e", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb_kernelili64elb1e", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb16_kernel<true>", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_cb16_kernelilb1e", "ssd bwd wgmma: C.B^T, B.C^T"),
          ("ssd_bwd_segment_ends", "ssd bwd wgmma: segment ends"),
          ("ssd_bwd_fold", "ssd bwd wgmma: fold"),
          ("ssd_bwd_chunk_kernel", "ssd bwd wgmma: in-chunk gradients"),
          ("ssd_bwd_sums", "ssd bwd wgmma: group and dA sums"),
          ("ssd_bwd_states", "ssd bwd fma: (a) entering states"),
          ("ssd_bwd_dstates", "ssd bwd fma: (b) state gradients"),
          ("ssd_bwd_chunk", "ssd bwd fma: (c) in-chunk gradients"),
          ("ssd_bwd_sum", "ssd bwd fma: (d) partials' sums"),
          ("ssd_cb", "ssd forward wgmma: C.B^T"),
          ("ssd_segment_states", "ssd forward wgmma: segment states"),
          ("ssd_chunk_scan", "ssd forward wgmma: scan"),
          ("ssd_scan_kernel", "ssd forward fma"),
          ("ssd_", "ssd forward"),
          ("flash_bwd_delta", "flash bwd: D = rowsum(dO o)"), ("flash_bwd_dkdv", "flash bwd: dK dV"),
          ("flash_bwd_dq", "flash bwd: dQ"), ("flash_bwd_sum", "flash bwd: dK dV partials' sum"),
          ("flash_fwd", "flash forward"),
          ("flash_wgmma", "flash forward"),
          ("rmsnorm_bwd", "rmsnorm backward"), ("rmsnorm", "rmsnorm forward"),
          ("gemm", "GEMMs (cuBLAS)"), ("cutlass", "GEMMs (cuBLAS)"), ("xmma", "GEMMs (cuBLAS)"),
          ("nvjet", "GEMMs (cuBLAS)"), ("elementwise", "elementwise"),
          ("vectorized", "elementwise"), ("reduce", "reductions"),
          ("tensor_kernel_scan", "cumsum (MoE slots)"), ("index", "gather/scatter"),
          ("scatter", "gather/scatter"), ("sort", "gather/scatter"),
          ("nccl", "NCCL collectives"))

GEMM = "GEMMs (cuBLAS)"

# the group labels' leading words -> the port's kernel whose launch runs them
PORT = (("ssd bwd", "ssd_scan_bwd"), ("ssd forward", "ssd_scan"),
        ("flash bwd", "flash_attention_bwd"), ("flash forward", "flash_attention"),
        ("rmsnorm backward", "rmsnorm_bwd"), ("rmsnorm forward", "rmsnorm"))


def group(name: str) -> str:
    low = name.lower()
    for key, label in GROUPS:
        if key in low:
            return label
    return "other"


def port_kernel(label: str):
    """The port's kernel a group belongs to, or None for cuBLAS and eager."""
    for lead, kernel in PORT:
        if label.startswith(lead):
            return kernel
    return None


def layer(label: str) -> str:
    """"port" for the port's kernels, "gemm" for cuBLAS, "eager" for the rest."""
    if port_kernel(label) is not None:
        return "port"
    return "gemm" if label == GEMM else "eager"
