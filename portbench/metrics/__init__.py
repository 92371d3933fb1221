"""Per-layer metrics, one reader a file: ``metrics/<name>.py`` holds
``read(trace) -> float | None`` for the metric ``<name>`` of
``BENCHMARK.json``. A reader that finds nothing to read returns None and
the metric is left out of the result's line. ``common`` holds what the
readers share."""
