"""The readers of the benchmark's metrics, one file per metric."""
