"""The general parts of the benchmark: cells found by name, seeds, weights,
traffic, work arithmetic and the device trace."""
