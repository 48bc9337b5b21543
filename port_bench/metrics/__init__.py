"""Per-layer metrics, one reader a file, named as in BENCHMARK.json.
Each has read(ctx, window, out) -> value or None: `window` is the traced
call (lib/trace.py Window; None when the run traced nothing), `out` the
driver's window result. A reader that finds nothing to read returns None
and the metric is left out of the line."""
