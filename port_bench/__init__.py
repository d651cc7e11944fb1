"""The port's benchmark: harness, drivers, reference and cost model."""
