"""service.frame_p90_ms: `frame_p90_ms` (the nearest-rank 90th percentile
of every request of the window, client-timed; a failed request counts as
infinite), read per layer in the cells where it is no end-to-end metric
because its runs spread too widely for a bound (layer: HTTP service)."""

from portbench.harness import reader

read = reader("frame_p90_ms")
