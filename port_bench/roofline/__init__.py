"""The yardstick of the per-layer metrics: the card's peaks, and the
operations and bytes of the port's kernels and of a whole sampling or fit
step, all computed from shapes."""
