"""The benchmark harness: one run of one cell (`harness.run_cell`), the traffic generator, the check against the reference, the traced sub-window, and the lookup of the files BENCHMARK.json names."""
