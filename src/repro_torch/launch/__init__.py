"""Launch helpers of the port (only ``scale_arch`` so far; the training
loop joins with the training slice)."""
