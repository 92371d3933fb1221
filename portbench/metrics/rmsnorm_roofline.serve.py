"""rmsnorm_roofline.serve: the RMSNorm launches' least time,
forward and backward where they ran (each the larger of its bytes at
3.35 TB/s and its fp32 operations at 67 TFLOP/s), over the summed
device time of the port's RMSNorm kernels, in percent."""

from portbench.metrics.common import roofline_pct


def read(tr):
    return roofline_pct(tr, ("rmsnorm", "rmsnorm_bwd"))
