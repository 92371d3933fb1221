"""Training substrate of the port: the counterpart of ``repro.train``
(optimizer, the microbatched train step on one device or FSDP x
TP-sharded on a mesh, the numpy data pipeline, checkpoints in the
reference's on-disk format, straggler monitoring, restart and elastic
resharding)."""
