"""The benchmark of ``icer_compression_tpu_torch`` on NVIDIA GPUs.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Configurations (``configs/``), traffic mixes (``traffic/``)
and per-layer metric readers (``metrics/``) are found by name.
"""
