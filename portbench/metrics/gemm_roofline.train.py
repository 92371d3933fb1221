"""gemm_roofline.train: the GEMMs' least time from their shapes
(each the larger of 2 m k n at 989 TFLOP/s and its operands and product
at 3.35 TB/s) over the summed device time of the cuBLAS kernels, in
percent."""

from portbench.metrics.common import roofline_pct


def read(tr):
    return roofline_pct(tr, ("gemm",))
