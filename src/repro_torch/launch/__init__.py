"""Launch helpers of the port: ``train`` (``scale_arch``, the train loop,
``main``), ``mesh`` (device meshes), ``presets`` (per-cell microbatching
and precision), ``input_specs`` (meta-tensor inputs), ``comm_analysis``
(collective accounting) and ``dryrun`` (every cell on meta tensors)."""
