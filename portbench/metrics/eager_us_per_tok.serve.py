"""eager_us_per_tok.serve: device time in ops that are neither cuBLAS
GEMMs nor the port's kernels, per prompt token of the traced window, in
us. Moves prefill_tokens_per_s."""

from portbench.metrics.common import eager_s


def read(tr):
    return 1e6 * eager_s(tr) / tr.work["tokens"]
