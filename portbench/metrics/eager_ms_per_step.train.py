"""eager_ms_per_step.train: device time a train step in ops that are
neither cuBLAS GEMMs nor the port's kernels (Adam, the accumulation,
casts, the SSM mixer's gating and conv), in ms. Moves train_tokens_per_s."""

from portbench.metrics.common import eager_s


def read(tr):
    return 1e3 * eager_s(tr) / tr.work["steps"]
