"""The benchmark of droid_slam_tpu_torch (see BENCHMARK.json and PERF.md)."""
