"""The benchmark of ``kinpoly_tpu_torch``: cells read from ``BENCHMARK.json``,
configurations from ``configs/``, traffic mixes from ``traffic/`` and metric
readers from ``metrics/``, each found by its name."""
