"""Device selection and host <-> device copies for the port's entry points.

``device=None`` means ``"cuda"``.  There is no silent host fallback: without
a CUDA device the caller has to ask for ``"cpu"`` explicitly.

``to_device`` and ``to_host`` move per-call data without making the host
wait: on a CUDA device both copies go through pinned host buffers with
``non_blocking=True``, so a dispatch half that only uploads, launches and
starts its downloads returns before the card is done (the ``defer``
collectors).  A host array read from a pinned download is valid only after
an event recorded behind the copy has fired (``Pending``).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  On a CUDA device it goes up
    from a pinned copy, ``non_blocking``: the host does not wait, and the
    pinned buffer is not reused before the copy is done (the caching host
    allocator records the copy).  The pinned buffer comes from
    ``torch.empty(pin_memory=True)``, a block of the caching host allocator
    filled by one host copy."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged.to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Start copying ``t`` into a pinned host tensor, ``non_blocking``; a
    CPU tensor is returned as it is.  Read the result only after the
    ``Pending`` that covers the copy has waited."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class Pending:
    """The end of a dispatch half: an event recorded on the current stream
    behind the work and downloads queued so far, and the device tensors
    that work reads or writes, kept alive until the event has fired so
    that the caching allocator cannot hand their memory to other work
    while a kernel or copy still uses it."""

    def __init__(self, device: torch.device, keep=()):
        self.keep = keep
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def ready(self) -> bool:
        """Whether the work and downloads are done, without waiting."""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
        self.keep = ()
