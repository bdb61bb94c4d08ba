"""Benchmark of the PyTorch/CUDA port's coded matrix product (``repro_torch``).

``python -m coded_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Each configuration,
traffic mix, entry and per-layer metric lives in a file of its own that the
harness finds by the name ``BENCHMARK.json`` gives it.
"""
