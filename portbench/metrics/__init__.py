"""The per-layer metrics, one reader per file, found by the metric's name."""
