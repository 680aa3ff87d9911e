"""Traffic: one data file a cell (``<cell>.json``) and one module a kind of
traffic (``<generator>.py``), which reads it; ``generator.py`` holds what
the kinds share."""
