"""moe_eager_us_per_tok.serve: device time of the ops launched inside
the program's ``host.layer.moe`` spans that are not GEMMs (the router's
softmax and top-k, the sort, the offsets, the gathers, the scatter, the
gating, the combine, the SiLUs), per prompt token of the traced cycle, in
us. Moves prefill_tokens_per_s."""


def read(tr):
    span = tr.work.get("device_by_span", {}).get("host.layer.moe")
    if span is None:
        return None
    gemm = tr.work.get("gemm_by_span", {}).get("host.layer.moe", 0)
    return 1e-3 * (span - gemm) / tr.work["tokens"]
