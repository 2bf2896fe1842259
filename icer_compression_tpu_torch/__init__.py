"""PyTorch/CUDA port of the ICER codec (counterpart: ``icer_compression_tpu``).

The grayscale and colour encode and decode run on an NVIDIA Hopper card:
plain PyTorch for the forward DWT and the finalize, and CUDA C++ kernels
for the rest: ``csrc/context_model.cu`` (the context model, coefficients
to coder words), ``csrc/slim_encode.cu`` (kernel 1, the slim coder),
``csrc/slim_pack.cu`` (its sort and pack), ``csrc/plane_decode.cu``
(kernels 2 and 3, the plane decoders), ``csrc/full_encode.cu`` (kernels 4
and 5, the full state-machine coder) and ``csrc/wavelet.cu`` (the inverse
DWT).  The streams are byte-identical to the JAX package's.

Entry points: ``models.grayscale.compress`` / ``decompress``, the batch
forms ``models.grayscale.compress_batch`` / ``models.decode.decompress_batch``
(with ``defer`` collectors), the colour codec ``models.color.compress_yuv`` /
``decompress_yuv`` / ``compress_yuv_batch`` and
``models.decode.decompress_yuv_batch``, and the command line
``python -m icer_compression_tpu_torch.cli``.  Each takes ``device=None``
(meaning ``"cuda"``); pass ``device="cpu"`` to run the kernels' plain
PyTorch versions on the host.  ``compress``, ``decompress``,
``compress_yuv`` and ``decompress_yuv`` also take ``backend=``: the
host codec on the native runtime (``"native"``) or plane by plane
(``"numpy"`` encode, ``"python"`` decode).  ``parallel/`` shards encode
and decode over the ranks of a ``torch.distributed`` process group
(``parallel.distributed.initialize``, ``parallel.sharded``).
"""
