"""step_mfu.train: the model's operations of a train step (every
product of matrices and the SSD scan and attention, forward and backward,
from shapes; remat off) over the host-clock time of the same steps run
without the profiler, at 989 TFLOP/s. Moves train_tokens_per_s."""

from portbench.metrics.common import mfu_pct


def read(tr):
    return mfu_pct(tr, tr.work["plain_window_s"])
