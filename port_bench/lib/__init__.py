"""The harness's shared parts: loading a cell by name, the card and the
forbidden-module checks, the profiler window and the emulated precisions."""
