"""Per-layer metric readers, one file a metric (``<metric>.py``). Each
declares its layer, unit, source and the end-to-end metric it moves, and
``read(measure)`` returns the value or None where it finds nothing to
read."""
