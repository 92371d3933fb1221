"""Training substrate of the port: the counterpart of ``repro.train``
(optimizer, microbatched single-device train step, the numpy data
pipeline, checkpoints in the reference's on-disk format, straggler
monitoring and restart)."""
