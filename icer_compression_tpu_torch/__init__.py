"""PyTorch/CUDA port of the ICER codec (counterpart: ``icer_compression_tpu``).

The grayscale encode and decode main path runs on an NVIDIA Hopper card:
plain PyTorch for the data-parallel stages (DWT, context modelling, record
sort and bit packing, finalize) and two CUDA C++ kernels for the serial
per-lane cores (``csrc/slim_encode.cu``, ``csrc/plane_decode.cu``).  The
streams are byte-identical to the JAX package's.

Entry points: ``models.grayscale.compress`` / ``decompress`` and the batch
forms ``models.grayscale.compress_batch`` / ``models.decode.decompress_batch``.
Each takes ``device=None`` (meaning ``"cuda"``); pass ``device="cpu"`` to run
the kernels' plain PyTorch versions on the host.
"""
