"""Launch helpers of the port: ``train`` (``scale_arch``, the train loop,
``main``) and ``mesh`` (device meshes)."""
