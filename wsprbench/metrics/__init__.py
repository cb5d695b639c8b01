"""Per-layer metric readers, one module a metric, found by the metric's
name: ``read(trace)`` returns the number, or None where the traced
window holds nothing to read (the metric is then left out)."""
