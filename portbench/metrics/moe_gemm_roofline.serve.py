"""moe_gemm_roofline.serve: the MoE layers' products' least time over
the traced cycle (the router's fp32 product, the routed experts' grouped
products with each expert that got rows read once a layer call, from the
program's counters, and the shared expert's; ``flops.hybrid.moe_bound``)
over the device time of the GEMM kernels launched inside the program's
``host.layer.moe`` spans, in percent. Moves prefill_tokens_per_s."""


def read(tr):
    spent = tr.work.get("gemm_by_span", {}).get("host.layer.moe", 0) / 1e9
    bound = tr.work.get("moe_bound_s", 0.0)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
