"""Per-layer metrics, one module a metric, named as in BENCHMARK.json."""
