"""Worker processes that code segment planes for ``codec.encode``.

Each worker is ``python -m benchmark.reference.workers`` over its own
pipes: it receives the images' coefficients once, then lists of lanes
(image, rectangle, subband, lsb), models and codes them (``lanes``) and
sends back the payloads.  Messages are length-prefixed pickles; only this
module writes them.  No shared memory, no files.
"""

from __future__ import annotations

import pickle
import struct
import subprocess
import sys

import numpy as np

_LEN = struct.Struct("<Q")


def _send(f, obj) -> None:
    data = pickle.dumps(obj, protocol=5)
    f.write(_LEN.pack(len(data)))
    f.write(data)
    f.flush()


def _recv(f):
    head = f.read(_LEN.size)
    if len(head) < _LEN.size:
        raise EOFError("worker pipe closed")
    (n,) = _LEN.unpack(head)
    return pickle.loads(f.read(n))


def code_lanes(coeffs, specs, mag_bits: int, window: int):
    """Payloads of the lanes ``specs``: (image, row, col, h, w, subband,
    lsb), each a segment plane of ``coeffs[image]``, with a codeword
    buffer of ``window`` words."""
    from . import lanes
    from .context_model import plane_emissions
    binned = []
    for i, r, c, h, w, sb, lsb in specs:
        valid, ctx, bit = plane_emissions(coeffs[i][r:r + h, c:c + w], sb,
                                          lsb, mag_bits)
        keep = valid.astype(bool)
        binned.append(lanes.coded_bins(ctx[keep], bit[keep]))
    return lanes.code_bins(binned, window)


class Workers:
    """``n`` worker processes (0: code in this process)."""

    def __init__(self, n: int):
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "benchmark.reference.workers"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            for _ in range(n)]
        self.coeffs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        for p in self.procs:
            try:
                _send(p.stdin, ("exit",))
                p.stdin.close()
            except (BrokenPipeError, ValueError):
                pass
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs = []

    def set_images(self, coeffs) -> None:
        self.coeffs = [np.ascontiguousarray(c, np.int32) for c in coeffs]
        for p in self.procs:
            _send(p.stdin, ("images", self.coeffs))

    def code(self, specs, mag_bits: int, window: int):
        """Payloads of ``specs`` in order, the lanes dealt out longest
        first so that every worker gets a like share."""
        if not self.procs:
            return code_lanes(self.coeffs, specs, mag_bits, window)
        order = sorted(range(len(specs)),
                       key=lambda j: -specs[j][3] * specs[j][4])
        shares = [order[k::len(self.procs)] for k in range(len(self.procs))]
        for p, share in zip(self.procs, shares):
            _send(p.stdin, ("lanes", [specs[j] for j in share], mag_bits,
                            window))
        out = [None] * len(specs)
        for p, share in zip(self.procs, shares):
            reply = _recv(p.stdout)
            if isinstance(reply, BaseException):
                raise RuntimeError("reference worker failed") from reply
            for j, res in zip(share, reply):
                out[j] = res
        return out


def main() -> None:
    fin, fout = sys.stdin.buffer, sys.stdout.buffer
    coeffs = None
    while True:
        msg = _recv(fin)
        if msg[0] == "exit":
            return
        if msg[0] == "images":
            coeffs = msg[1]
            continue
        try:
            reply = code_lanes(coeffs, msg[1], msg[2], msg[3])
        except Exception as exc:  # reported to the parent, which raises
            reply = exc
        _send(fout, reply)


if __name__ == "__main__":
    main()
