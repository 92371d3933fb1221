"""ssd_scan_roofline.train: the SSD scan launches' least time,
forward and backward (each the larger of its bytes at 3.35 TB/s and its
chunked products at 989 TFLOP/s), over the summed device time of the
port's SSD kernels, in percent."""

from portbench.metrics.common import roofline_pct


def read(tr):
    return roofline_pct(tr, ("ssd_scan", "ssd_scan_bwd"))
