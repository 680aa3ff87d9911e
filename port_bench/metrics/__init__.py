"""Per-layer metrics: one reader a metric, ``<metric name>.py``, with
``read(ctx) -> float | None`` (None: nothing to read in this run)."""
