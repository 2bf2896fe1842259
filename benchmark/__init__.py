"""The benchmark of ``icer_compression_tpu_torch`` on NVIDIA GPUs.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Configurations (``configs/``), traffic mixes (``traffic/``),
per-layer metric readers (``metrics/``) and traffic modes beyond the
built-in ones (``modes/``) are found by name.
"""


class Failed(Exception):
    """The run cannot give a result.  Defined here, in a module that is
    never ``__main__``, so that ``benchmark.run`` started with ``-m``
    catches what the load generator and the mode files raise."""
