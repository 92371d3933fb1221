"""flash_attention_roofline.serve: the flash forward launches'
least time over the window's prompt lengths (each the larger of q, k, v
and o at 3.35 TB/s and its products over the causal pairs at
989 TFLOP/s), over the summed device time of the port's flash kernels,
in percent."""

from portbench.metrics.common import roofline_pct


def read(tr):
    return roofline_pct(tr, ("flash_attention",))
