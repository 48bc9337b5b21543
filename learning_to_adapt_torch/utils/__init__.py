"""Host-side utilities: logger, config helpers, checkpoints, profiling and
the constructor-replay pickling protocol (utils/ of the JAX package)."""
