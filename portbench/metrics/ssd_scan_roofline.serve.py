"""ssd_scan_roofline.serve: the SSD scan forward launches' least time
over the traced prompts (each the larger of its bytes at 3.35 TB/s and
its chunked products at 989 TFLOP/s), over the summed device time of the
port's SSD forward kernels, in percent. Moves prefill_tokens_per_s."""

from portbench.metrics.common import roofline_pct


def read(tr):
    return roofline_pct(tr, ("ssd_scan",))
