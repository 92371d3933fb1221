"""step_mfu.serve: the model's operations of the traced window's
prompts (products of matrices and attention, from shapes) over the
host-clock time of the same requests served without the profiler, at
989 TFLOP/s. Moves prefill_tokens_per_s."""

from portbench.metrics.common import mfu_pct


def read(tr):
    return mfu_pct(tr, tr.work["plain_window_s"])
