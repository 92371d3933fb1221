"""device_idle_pct.train: the share of the traced work's time in which no
device op ran: one minus pass A's busy time (the union of its device ops'
intervals) over the host-clock time of the same work run without the
profiler, in percent. Moves train_tokens_per_s."""

from portbench.metrics.common import idle_pct


def read(tr):
    return idle_pct(tr)
