"""PyTorch/CUDA port of the ICER codec (counterpart: ``icer_compression_tpu``).

The grayscale and colour encode and decode run on an NVIDIA Hopper card:
plain PyTorch for the data-parallel stages (DWT, context modelling, record
sort and bit packing, finalize) and two CUDA C++ kernels for the serial
per-lane cores (``csrc/slim_encode.cu``, ``csrc/plane_decode.cu``).  The
streams are byte-identical to the JAX package's.

Entry points: ``models.grayscale.compress`` / ``decompress``, the batch
forms ``models.grayscale.compress_batch`` / ``models.decode.decompress_batch``
(with ``defer`` collectors), the colour codec ``models.color.compress_yuv`` /
``decompress_yuv`` / ``compress_yuv_batch`` and
``models.decode.decompress_yuv_batch``, and the command line
``python -m icer_compression_tpu_torch.cli``.  Each takes ``device=None``
(meaning ``"cuda"``); pass ``device="cpu"`` to run the kernels' plain
PyTorch versions on the host.
"""
