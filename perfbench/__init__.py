"""The benchmark of richdem_tpu_torch: see BENCHMARK.json and PERF.md."""
