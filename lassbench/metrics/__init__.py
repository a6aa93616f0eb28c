"""Per-layer metric readers, one module a metric (the part of its name
before the first dot): ``read(run, name)`` -> the number, or None where
the run holds nothing to read it from; the result line then leaves the
metric out. A share of a peak or a roofline is never made up as 0."""
