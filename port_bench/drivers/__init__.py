"""Drivers, one a kind of traffic (a workload file's "driver"). Each has
setup(ctx) -> state, window(ctx, state) -> dict (lib/run.py),
release(state) and readings(ctx, state, mode) -> {number: value};
lib/run.py runs them in that order."""
