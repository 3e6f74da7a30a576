"""The per-layer metrics, a reader a metric: ``<metric>.py`` with its dots
and dashes written as underscores, ``read(rec) -> float | None``."""
