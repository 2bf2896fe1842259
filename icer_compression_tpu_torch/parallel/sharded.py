"""Sharded encode and decode over a ('data', 'seg') mesh of process ranks.

Counterpart: ``icer_compression_tpu/parallel/sharded.py``
(``ShardedGrayscaleEncoder``, ``ShardedColorEncoder``,
``ShardedGrayscaleDecoder``, ``decode_batch_sharded``, ``make_mesh``).
The codec's own parallel axes, one device per rank:

  * ``data``: the batch of images; rank (d, s) takes images d * B/D ..
    (d + 1) * B/D - 1;
  * ``seg``: the segment lanes inside an image.  Every stage group's
    lanes, padded with dummy lanes to a multiple of S, are cut into S
    equal runs and rank (d, s) codes run s (``ops/encode._plan_groups``);
    every lane codes with state of its own.

Each rank runs the single-card machinery on its own device: the
transform, emission words, buckets and coders (kernel 1 on every bucket
under the ``auto`` coder) of ``ops/encode.TorchGrayscaleEncoder``, with
the exact native re-encode of the lanes it flags.  The one collective of the encode is the ordered
gather of the per-lane payload tables (the JAX ``_host``): an all_gather
of bit lengths, then of the padded payload bytes, in (data, seg) rank
order, so that every rank returns the whole batch's tables.  The decode
plans each data row's streams on every rank of the row, runs kernel 2 on
the rank's run of each unit's lanes, gathers the decoded lane planes
within the row, finalizes the row's images and gathers the images, so
that every rank returns the whole batch.  Its two device halves, kernel 2
on the rank's share and the finalize, each run as a captured CUDA graph
of its own key on the card (``models.decode.run_pass``), as the JAX
sharded decoder jits two programs.  A failure on one rank raises on
every rank (``_agree``), so no rank waits in a collective for a rank that
has given up.

The JAX encoder's compact-blob fetch (``_encode_batch_compact``) is not
ported: its zero-tile lanes clip onto tile BT-1 when the payload exactly
fills the budget (a known reference-side defect); the port's own fetch
copies each bucket's payload rows as they are.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core.status import IcerError, IcerStatus
from ..ops.encode import TorchGrayscaleEncoder, _plan_groups
from .distributed import all_gather_arrays, rank_device, world


@dataclass(frozen=True)
class Mesh:
    """A (data, seg) grid of the process group's ranks, rank r at (r //
    seg, r % seg), each on its own ``device``.  ``seg_group`` is the
    process group of this rank's data row (None: the world, or no group
    at all)."""
    data: int
    seg: int
    rank: int
    device: torch.device
    seg_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "seg": self.seg}

    @property
    def data_rank(self) -> int:
        return self.rank // self.seg

    @property
    def seg_rank(self) -> int:
        return self.rank % self.seg


def mesh_shape(n: int, data: int | None = None) -> tuple[int, int]:
    """(data, seg) of an n-rank mesh.  By default both axes carry when
    n > 1: data parallelism takes the larger factor and seg = 2 keeps the
    lane axis exercised with the least lane padding; odd n has no even
    split, so the whole mesh goes to seg (the JAX ``make_mesh`` rule)."""
    if data is None:
        if n == 1:
            return 1, 1
        if n % 2 == 0:
            return n // 2, 2
        return 1, n
    if data <= 0 or n % data:
        raise ValueError(f"data axis {data} does not divide {n} ranks")
    return data, n // data


def make_mesh(n_devices: int | None = None, data: int | None = None,
              device=None) -> Mesh:
    """The ('data', 'seg') mesh over the ranks of the process group (a
    world of 1 without a group is a 1 x 1 mesh).  ``n_devices``, if given,
    must be the world size; ``device`` is this rank's device (None: the
    current CUDA device, the one ``distributed.initialize`` set; pass
    ``"cpu"`` for a host world).  Every rank must call it, in the same
    order, since the row groups are created collectively."""
    n, rank = world()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"{n_devices} devices asked, the world has {n} "
                         "ranks: a mesh spans the whole process group")
    D, S = mesh_shape(n, data)
    group = None
    if n > 1 and D > 1 and S > 1:
        rows = [dist.new_group(list(range(d * S, (d + 1) * S)))
                for d in range(D)]
        group = rows[rank // S]
    return Mesh(D, S, rank, rank_device(device), group)


def _describe(e: Exception):
    if isinstance(e, IcerError):
        return ("icer", int(e.status), str(e))
    return ("other", 0, f"{type(e).__name__}: {e}")


def _agree(fn):
    """Run ``fn`` on every rank; when it raises on any rank, every rank
    raises: the rank's own exception, or one naming the first failed rank
    (an ``IcerError`` of its status, else ``RuntimeError``)."""
    err = res = None
    try:
        res = fn()
    except Exception as e:       # re-raised on every rank below
        err = e
    n, _rank = world()
    if n > 1:
        got = [None] * n
        dist.all_gather_object(got, None if err is None else _describe(err))
        if err is None:
            for r, d in enumerate(got):
                if d is None:
                    continue
                kind, status, msg = d
                if kind == "icer":
                    raise IcerError(IcerStatus(status),
                                    f"on rank {r}: {msg}")
                raise RuntimeError(f"rank {r} failed: {msg}")
    if err is not None:
        raise err
    return res


def _check_batch(n: int, data: int) -> int:
    if n == 0 or n % data:
        raise IcerError(IcerStatus.INVALID_INPUT,
                        f"batch size {n} must be a positive multiple of the "
                        f"data axis ({data})")
    return n // data


class ShardedGrayscaleEncoder:
    """Batched grayscale encode sharded over a ('data', 'seg') mesh."""

    def __init__(self, mesh: Mesh, image_w: int, image_h: int, stages: int,
                 filt: int, segments: int, mag_bits: int = 15):
        self.mesh = mesh
        self.w, self.h = image_w, image_h
        self.stages, self.filt, self.segments = stages, filt, segments
        self.mag_bits = mag_bits
        self.enc = TorchGrayscaleEncoder(
            image_w, image_h, stages, filt, segments, mag_bits, mesh.device,
            entropy="auto", lane_share=(mesh.seg, mesh.seg_rank))
        self.bitplanes = self.enc.bitplanes
        # every seg run's table keys in gather order (None: a dummy lane)
        self._keys = []
        for s in range(mesh.seg):
            keys = []
            for g in _plan_groups(image_w, image_h, stages, segments,
                                  (mesh.seg, s)):
                keys += [None if l.dummy
                         else (l.stage, l.subband, lsb, l.seg)
                         for lsb in range(self.bitplanes)
                         for l in g["lanes"]]
            self._keys.append(keys)

    def encode_batch(self, images: np.ndarray):
        """images (B, h, w), B a multiple of the data axis -> (ll_means
        (B,), tables): tables[b] maps (stage, subband, lsb, seg) ->
        (payload bytes, bit length), every rank returning the whole
        batch's.  Raises IcerError(INTEGER_OVERFLOW) on every rank when a
        DWT wraps or an LL mean passes the magnitude field on any rank
        (the reference's ICER_INTEGER_OVERFLOW, icer_wavelet.c:243)."""
        images = np.asarray(images)
        D, S = self.mesh.data, self.mesh.seg
        Bl = _check_batch(len(images), D)
        d, s = self.mesh.data_rank, self.mesh.seg_rank
        res = _agree(lambda: self.enc.encode_batch(images[d * Bl:
                                                          (d + 1) * Bl]))
        keys = self._keys[s]
        nbits = np.zeros((Bl, len(keys)), np.int64)
        parts = []
        for i, (table, _mean) in enumerate(res):
            for j, key in enumerate(keys):
                if key is not None:
                    payload, nbits[i, j] = table[key]
                    parts.append(payload)
        blob = b"".join(parts)
        head = np.concatenate([[len(blob)], [m for _t, m in res],
                               nbits.reshape(-1)]).astype(np.int64)
        heads = all_gather_arrays(head, self.mesh.device)
        padded = np.zeros(max(1, max(int(x[0]) for x in heads)), np.uint8)
        padded[:len(blob)] = np.frombuffer(blob, np.uint8)
        blobs = all_gather_arrays(padded, self.mesh.device)

        B = len(images)
        ll_means = np.zeros(B, np.int64)
        tables: list[dict] = [{} for _ in range(B)]
        for r, (head_r, buf) in enumerate(zip(heads, blobs)):
            dr, sr = divmod(r, S)
            keys_r = self._keys[sr]
            nb_r = head_r[1 + Bl:].reshape(Bl, len(keys_r))
            off = 0
            for i in range(Bl):
                bi = dr * Bl + i
                ll_means[bi] = head_r[1 + i]
                for j, key in enumerate(keys_r):
                    if key is not None:
                        nb = int(nb_r[i, j])
                        n = (nb + 7) // 8
                        tables[bi][key] = (buf[off:off + n].tobytes(), nb)
                        off += n
        return ll_means, tables

    def compress_batch(self, images: np.ndarray, config) -> list[bytes]:
        """One stream per image under ``config``'s quota, each equal to
        models.grayscale.compress of it."""
        from ..models.grayscale import _allocate_stream
        ll_means, tables = self.encode_batch(images)
        return [_allocate_stream({(0,) + k: v for k, v in t.items()},
                                 int(m), config, self.w, self.h,
                                 self.bitplanes)
                for t, m in zip(tables, ll_means)]


class ShardedColorEncoder:
    """Batched YUV encode sharded over a ('data', 'seg') mesh: the channels
    fold into the data axis (a batch of B colour images encodes as 3B
    channel canvases, Y then U then V), so (3 * B) % mesh data must be 0;
    rate allocation and stream assembly run per image
    (icer_color.c:343-456)."""

    def __init__(self, mesh: Mesh, image_w: int, image_h: int, stages: int,
                 filt: int, segments: int, mag_bits: int = 15):
        self._g = ShardedGrayscaleEncoder(mesh, image_w, image_h, stages,
                                          filt, segments, mag_bits)
        self.mag_bits = mag_bits
        self.bitplanes = self._g.bitplanes

    def encode_batch_yuv(self, ys, us, vs):
        """(B, h, w) x 3 -> per image (ll_means [y, u, v], table); table
        maps (chan, stage, subband, lsb, seg) -> (payload, bit length)."""
        return [([m for _t, m in res],
                 {(c,) + k: v for c, (t, _m) in enumerate(res)
                  for k, v in t.items()})
                for res in self._channels(ys, us, vs)]

    def _channels(self, ys, us, vs):
        """Per image, its three channels' (table, ll_mean)."""
        ys, us, vs = (np.asarray(c) for c in (ys, us, vs))
        B = ys.shape[0]
        ll, tables = self._g.encode_batch(np.concatenate([ys, us, vs]))
        return [[(tables[c * B + i], int(ll[c * B + i])) for c in range(3)]
                for i in range(B)]

    def compress_batch(self, ys, us, vs, config) -> list[bytes]:
        """One stream per image, each equal to models.color.compress_yuv
        of its planes."""
        from ..models.color import _allocate_yuv, _rearrange_order
        order = _rearrange_order(self.mag_bits, self.bitplanes)
        return [_allocate_yuv(res, config, self._g.w, self._g.h,
                              self.bitplanes, order)
                for res in self._channels(ys, us, vs)]


class ShardedGrayscaleDecoder:
    """Lane-batched grayscale decode over a ('data', 'seg') mesh: streams
    over ``data``, each unit's lanes over ``seg`` (every lane decodes from
    its own stream with state of its own), kernel 2 on every rank.  The
    decoded lane planes gather within the data row, which finalizes its
    images; the images then gather so every rank returns the whole batch,
    each pixel-equal to models.grayscale.decompress of its stream.
    ``graph`` as in ``models.decode.decompress_batch``: each device half
    (kernel 2 on the rank's share, the finalize) a captured CUDA graph of
    its own key."""

    def __init__(self, mesh: Mesh, image_w: int, image_h: int, config,
                 dtype=np.uint16, graph: bool | None = None):
        from ..models.decode import _use_graph
        from ..models.grayscale import _bitplanes, _mag_bits
        self.mesh = mesh
        self.w, self.h = image_w, image_h
        self.config = config
        self.dtype = np.dtype(dtype)
        self.mag_bits = _mag_bits(self.dtype)
        self.bitplanes = _bitplanes(self.mag_bits)
        self.graph = _use_graph(graph, torch.device(mesh.device))

    def _plan(self, streams):
        from ..models.decode import plan_batch
        plan = plan_batch(streams, self.config, self.dtype, pad=True)
        if plan[:2] != (self.w, self.h):
            raise IcerError(IcerStatus.INVALID_INPUT,
                            "stream geometry differs from decoder plan")
        return plan

    def _key(self, half, *fields):
        c = self.config
        return ("decode", half, self.w, self.h, c.stages, c.filt,
                c.segments, self.mag_bits) + fields + (str(self.mesh.device),)

    def _decode_share(self, blob, units):
        """Kernel 2 on this rank's run of every unit's lanes; returns per
        unit (out (hmax * wmax, run length) on the host, run start)."""
        from ..device import to_device
        from ..models.decode import decode_units, run_pass, unit_views
        S, s = self.mesh.seg, self.mesh.seg_rank
        dev = self.mesh.device
        runs, mine = [], []
        for u in units:
            n = u["offs"].shape[1]
            per = -(-n // S)
            lo, hi = min(n, s * per), min(n, (s + 1) * per)
            runs.append((lo, hi, per))
            if hi > lo:
                mine.append(dict(u, offs=u["offs"][:, lo:hi],
                                 ebits=u["ebits"][:, lo:hi],
                                 lane_end=u["lane_end"][lo:hi],
                                 geom=u["geom"][:, lo:hi]))
        shapes = [(u["offs"].shape[0], u["offs"].shape[1], u["hmax"],
                   u["wmax"]) for u in mine]
        fields = ("offs", "ebits", "lane_end", "geom")
        meta = np.concatenate([np.zeros(0, np.int32)] + [
            u[k].ravel() for u in mine for k in fields]).astype(np.int32)

        def share(x):
            blob_t, meta_t = x
            inputs = [views + sh[2:] for views, sh in zip(
                unit_views(meta_t, 0, shapes, fields), shapes)]
            return tuple(out for out, _e, _p in decode_units(
                blob_t, inputs, self.bitplanes - 1, self.mag_bits))

        key = self._key("share", S, s, tuple(
            (u["bucket"],) + sh for u, sh in zip(mine, shapes)), len(blob))
        estimate = 4 * sum(R * n * 3 + hm * wm * n
                           for R, n, hm, wm in shapes)
        # a rank with no lane in any unit has nothing to run (and a graph
        # with no work is not captured)
        outs = iter(run_pass(
            key, share, (to_device(blob, dev), to_device(meta, dev)),
            self.graph, lambda o: [t.cpu().numpy() for t in o],
            estimate=estimate) if mine else ())
        pieces = []
        for u, (lo, hi, per) in zip(units, runs):
            piece = np.zeros((u["hmax"] * u["wmax"], per), np.int32)
            if hi > lo:
                piece[:, :hi - lo] = next(outs)
            pieces.append(piece)
        return pieces

    def _finalize(self, outs, units, ll_means):
        """The finalize of the row's images on this rank's device from
        each unit's gathered lanes (host arrays); returns the pixels on
        the host."""
        from ..device import to_device
        from ..models.decode import finalize, key_tables, run_pass
        dev = self.mesh.device
        NC = len(ll_means)
        key = self._key("finalize", NC, tuple(
            (u["bucket"], o.shape[1], u["hmax"], u["wmax"])
            for u, o in zip(units, outs)))
        tables = key_tables(key, units, NC, self.w, self.h, dev)
        x = tuple(to_device(o, dev) for o in outs) \
            + (to_device(np.asarray(ll_means, np.int32), dev),)

        def fin(x):
            return (finalize(x[:-1], tables, x[-1], self.w, self.h,
                             self.config, self.mag_bits),)

        return run_pass(key, fin, x, self.graph,
                        lambda o: o[0].cpu().numpy(), owner=tables,
                        estimate=40 * NC * self.h * self.w)

    def decode_batch(self, streams) -> list[np.ndarray]:
        D, S = self.mesh.data, self.mesh.seg
        B = len(streams)
        Bl = _check_batch(B, D)
        d = self.mesh.data_rank
        dev = self.mesh.device
        w, h, ll_means, blob, units = _agree(
            lambda: self._plan(streams[d * Bl:(d + 1) * Bl]))
        pieces = _agree(lambda: self._decode_share(blob, units))
        # the row's runs, joined in seg order, are each unit's lanes
        flat = np.concatenate([p.reshape(-1) for p in pieces])
        row = all_gather_arrays(flat, dev, self.mesh.seg_group) \
            if S > 1 else [flat]
        outs, off = [], 0
        for u, p in zip(units, pieces):
            size = p.size
            lanes = np.concatenate([r[off:off + size].reshape(p.shape)
                                    for r in row], axis=1)
            outs.append(np.ascontiguousarray(lanes[:, :u["offs"].shape[1]]))
            off += size
        px = _agree(lambda: self._finalize(outs, units, ll_means))
        imgs = all_gather_arrays(px, dev)
        return [imgs[(b // Bl) * S][b % Bl].astype(self.dtype)
                for b in range(B)]


def decode_batch_sharded(streams, config, dtype=np.uint16, devices=None,
                         backend: str | None = None,
                         max_workers: int | None = None):
    """Decode independent streams data-parallel over a list of torch
    devices: stream i on ``devices[i % len(devices)]``, one thread per
    device, each under ``torch.cuda.device`` of its card.  Decode needs no
    communication (every stream reconstructs its own image), so with one
    device (or none: ``"cuda"``) this is a loop over
    models.grayscale.decompress.  ``backend`` as for decompress.  On the
    card each decode runs its captured graphs (``models.decode``); threads
    that share a card share them through the graph cache's lock."""
    from ..models.grayscale import decompress

    def one(s, dev):
        dev = None if dev is None else torch.device(dev)
        ctx = torch.cuda.device(dev) if dev is not None \
            and dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            return decompress(s, config, dtype=dtype, device=dev,
                              backend=backend)

    if not devices or len(devices) == 1:
        dev = devices[0] if devices else None
        return [one(s, dev) for s in streams]
    with ThreadPoolExecutor(max_workers=max_workers or len(devices)) as ex:
        return list(ex.map(lambda a: one(a[1], devices[a[0] % len(devices)]),
                           enumerate(streams)))
