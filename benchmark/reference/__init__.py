"""The plain grayscale ICER codec that judges the benchmark (NumPy only).

Copies of the JAX package's host modules, which mirror lib_icer (the
reference C library) and are held to its outputs by the repository's
tests: ``constants``, ``status``, ``subbands``, ``partition``,
``packets``, ``header`` (``icer_compression_tpu/core``), ``bitutils``,
``wavelet`` (NumPy path only), ``context_model`` (``icer_compression_tpu/
ops``) and ``sequential`` (``icer_compression_tpu/backend``).  Written
here: ``lanes`` (the sequential coder stepped over many segment planes
at once), ``workers`` and ``codec``.  Nothing here imports the program,
JAX or the JAX package.
"""
