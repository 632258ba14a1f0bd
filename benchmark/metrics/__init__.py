"""One reader a metric: `metrics/<name>.py` with `read(ctx)`, which returns
the metric's value or None when the run gives it nothing to read (the
harness then leaves the metric out of the result line)."""
