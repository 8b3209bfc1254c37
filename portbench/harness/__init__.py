"""The general parts of the benchmark: inputs from the seed, the window,
the check, the trace reduction, the peaks and the lookup by name."""
