"""The port's multi-process codec (``parallel/distributed.py`` and
``parallel/sharded.py`` on ``torch.distributed``) against the JAX
package's sharded classes.

A world is two processes on the CPU joined over gloo: this file run as a
script (``python tests/test_torch_parallel.py worker RANK PORT DATA OUT``)
is one rank.  While a world runs, the test computes the JAX package's
``ShardedGrayscaleEncoder``, ``ShardedColorEncoder`` and
``ShardedGrayscaleDecoder`` on a CPU mesh of the same (data, seg) shape
(conftest sets up 8 virtual CPU devices); each rank's tables, streams and
pixels must equal them and the host codec's.  The 1 x 2 world (the seg
axis, with dummy lanes: stages 2 and 3 segments give the stage-1 group 9
lanes, padded to 10) runs here; the 2 x 1 world (the data axis) runs in
tests/test_torch_parallel_data.py, so that the two worlds' JAX references
run on two test workers.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

H = W = 24
STAGES, SEGMENTS = 2, 3
WORLD_TIMEOUT_S = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def images(seed: int = 5):
    """(uint16 batch, uint8 batch, three colour planes), two images each,
    and a uint8 batch whose image 0 (only) wraps the 7-bit DWT."""
    rng = np.random.default_rng(seed)
    ramp = np.add.outer(np.arange(H) * 3, np.arange(W))
    u16 = ((ramp % 150) + rng.integers(0, 40, (2, H, W))).astype(np.uint16)
    u8 = ((ramp % 60) + rng.integers(0, 20, (2, H, W))).astype(np.uint8)
    planes = [((ramp * k % 90) + rng.integers(0, 30, (2, H, W)))
              .astype(np.uint16) for k in (1, 2, 3)]
    wrap = np.stack([rng.integers(0, 250, (H, W)), ramp % 60]) \
        .astype(np.uint8)
    return u16, u8, planes, wrap


def _status(fn):
    from icer_compression_tpu_torch.core.status import IcerError
    try:
        fn()
    except IcerError as e:
        return int(e.status)
    return None


def worker(rank: int, port: int, data: int, out: str) -> None:
    """One rank of a gloo world of two on the CPU: every sharded class of
    the port on the (data, 2 / data) mesh; the results go to
    ``out/rank{rank}.pkl``."""
    import torch
    torch.set_num_threads(1)
    from icer_compression_tpu_torch.models.grayscale import CodecConfig
    from icer_compression_tpu_torch.parallel import distributed, sharded

    assert distributed.initialize(f"tcp://127.0.0.1:{port}", 2, rank,
                                  device="cpu")
    assert distributed.initialize()
    mesh = distributed.global_mesh(data=data, device="cpu")
    u16, u8, planes, wrap = images()
    cfg = CodecConfig(STAGES, 0, SEGMENTS, None)
    qcfg = CodecConfig(STAGES, 0, SEGMENTS, 300)
    enc = sharded.ShardedGrayscaleEncoder(mesh, W, H, STAGES, 0, SEGMENTS)
    enc8 = sharded.ShardedGrayscaleEncoder(mesh, W, H, STAGES, 0, SEGMENTS,
                                           mag_bits=7)
    res = {"shape": mesh.shape, "u16": enc.encode_batch(u16),
           "u16_streams": enc.compress_batch(u16, cfg),
           "q_streams": enc.compress_batch(u16, qcfg),
           "u8": enc8.encode_batch(u8),
           "u8_streams": enc8.compress_batch(u8, cfg),
           "colour": sharded.ShardedColorEncoder(
               mesh, W, H, STAGES, 0, SEGMENTS).compress_batch(*planes, cfg)}
    dec = sharded.ShardedGrayscaleDecoder(mesh, W, H, cfg)
    res["decoded"] = dec.decode_batch(res["u16_streams"])
    res["q_decoded"] = sharded.ShardedGrayscaleDecoder(
        mesh, W, H, qcfg).decode_batch(res["q_streams"])
    bad = data + 1 if data > 1 else 0
    res["odd_encode"] = _status(lambda: enc.encode_batch(u16[:1].repeat(
        bad, axis=0)))
    res["odd_decode"] = _status(lambda: dec.decode_batch(
        res["u16_streams"][:1] * bad))
    res["overflow"] = _status(lambda: enc8.encode_batch(wrap))
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(data: int, out, command=None,
                timeout: float = WORLD_TIMEOUT_S) -> tuple:
    """Start the two ranks of a gloo world on a free port: each runs
    ``command(rank, port)`` (default: this file's ``worker`` on the
    (data, 2 / data) mesh), writing ``out/rank{rank}.pkl``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    if command is None:
        def command(rank, port):
            return [sys.executable, os.path.abspath(__file__), "worker",
                    str(rank), str(port), str(data), str(out)]
    procs = [subprocess.Popen(
        command(rank, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for rank in range(2)]
    return procs, time.monotonic() + timeout


def finish_world(world, out) -> list:
    """Wait for both ranks (at most the world's timeout from their start)
    and load their results."""
    procs, deadline = world
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    results = []
    for rank in range(2):
        with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def jax_references(data: int) -> dict:
    """The JAX package's sharded classes on a CPU mesh of (data, 2 /
    data), and its host codec, on the worker's inputs."""
    from icer_compression_tpu.models import grayscale as G
    from icer_compression_tpu.parallel import sharded as JS
    mesh = JS.make_mesh(2, data=data, platform="cpu")
    assert dict(mesh.shape) == {"data": data, "seg": 2 // data}
    u16, u8, planes, _wrap = images()
    cfg = G.CodecConfig(STAGES, 0, SEGMENTS, None)
    enc = JS.ShardedGrayscaleEncoder(mesh, W, H, STAGES, 0, SEGMENTS)
    enc8 = JS.ShardedGrayscaleEncoder(mesh, W, H, STAGES, 0, SEGMENTS,
                                      mag_bits=7)
    streams = [G.compress(im, cfg) for im in u16]
    return {
        "u16": enc.encode_batch(u16), "u8": enc8.encode_batch(u8),
        "u16_streams": streams, "u8_streams": [G.compress(im, cfg)
                                               for im in u8],
        "colour": JS.ShardedColorEncoder(
            mesh, W, H, STAGES, 0, SEGMENTS).compress_batch(*planes, cfg),
        "decoded": JS.ShardedGrayscaleDecoder(mesh, W, H, cfg)
        .decode_batch(streams),
    }


def check_world(data: int, tmp_path) -> None:
    """Run the port's world of (data, 2 / data) and hold every rank's
    results to the JAX package's sharded classes and host codec."""
    from icer_compression_tpu.models import color as JC
    from icer_compression_tpu.models import grayscale as G
    from icer_compression_tpu_torch.core.status import IcerStatus
    world = start_world(data, tmp_path)
    try:
        ref = jax_references(data)
    finally:
        results = finish_world(world, tmp_path)
    u16, u8, planes, _wrap = images()
    cfg = G.CodecConfig(STAGES, 0, SEGMENTS, None)
    qcfg = G.CodecConfig(STAGES, 0, SEGMENTS, 300)
    colour = [JC.compress_yuv(*(p[i] for p in planes), cfg)
              for i in range(2)]
    for res in results:
        assert res["shape"] == {"data": data, "seg": 2 // data}
        for kind in ("u16", "u8"):
            (ll, tables), (jll, jtables) = res[kind], ref[kind]
            assert [int(x) for x in ll] == [int(x) for x in jll]
            assert tables == jtables
            assert res[kind + "_streams"] == ref[kind + "_streams"]
        # stage 1's 9 lanes took a dummy lane on the seg axis of 2
        assert all(k[3] >= 0 for t in res["u16"][1] for k in t)
        assert res["colour"] == ref["colour"] == colour
        for got, want, img in zip(res["decoded"], ref["decoded"], u16):
            assert got.dtype == want.dtype
            assert np.array_equal(got, want) and np.array_equal(got, img)
        assert res["q_streams"] == [G.compress(im, qcfg) for im in u16]
        for got, s in zip(res["q_decoded"], res["q_streams"]):
            assert np.array_equal(got, G.decompress(s, qcfg))
        assert res["odd_encode"] == res["odd_decode"] \
            == IcerStatus.INVALID_INPUT
        assert res["overflow"] == IcerStatus.INTEGER_OVERFLOW


def test_gloo_world_seg_axis_matches_jax_sharded(tmp_path):
    check_world(1, tmp_path)


def test_make_mesh_shapes_match_jax():
    from icer_compression_tpu.parallel import sharded as JS
    from icer_compression_tpu_torch.parallel import sharded as TS
    for n in range(1, 9):
        jax_shape = JS.make_mesh(n, platform="cpu").shape
        assert TS.mesh_shape(n) == (jax_shape["data"], jax_shape["seg"])
    for n, data in ((4, 4), (8, 2), (6, 3)):
        jax_shape = JS.make_mesh(n, data=data, platform="cpu").shape
        assert TS.mesh_shape(n, data) == (jax_shape["data"],
                                          jax_shape["seg"])
    with pytest.raises(ValueError):
        TS.mesh_shape(6, 4)


def test_single_process_is_a_one_by_one_mesh(monkeypatch):
    """Without a process group: ``initialize`` returns False, the mesh is
    1 x 1, and the sharded classes equal the host codec."""
    from icer_compression_tpu.models import grayscale as G
    from icer_compression_tpu_torch.parallel import distributed, sharded
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(world_size=1) is False
    assert distributed.world() == (1, 0)
    mesh = sharded.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, str(mesh.device)) == (
        {"data": 1, "seg": 1}, 0, "cpu")
    with pytest.raises(ValueError):
        sharded.make_mesh(2, device="cpu")
    u16, _u8, _planes, _wrap = images(7)
    cfg = G.CodecConfig(STAGES, 0, SEGMENTS, None)
    streams = sharded.ShardedGrayscaleEncoder(
        mesh, W, H, STAGES, 0, SEGMENTS).compress_batch(u16, cfg)
    assert streams == [G.compress(im, cfg) for im in u16]
    dec = sharded.ShardedGrayscaleDecoder(mesh, W, H, cfg)
    assert all(np.array_equal(a, b)
               for a, b in zip(dec.decode_batch(streams), u16))
    other = G.compress(np.zeros((H, W + 8), np.uint16), cfg)
    with pytest.raises(Exception, match="geometry"):
        dec.decode_batch([other])


def test_decode_batch_sharded_round_robin():
    """Streams round-robin over a list of devices, one thread each;
    pixels equal the JAX package's ``decode_batch_sharded``."""
    from icer_compression_tpu.models import grayscale as G
    from icer_compression_tpu.parallel import sharded as JS
    from icer_compression_tpu_torch.parallel import sharded as TS
    u16, _u8, _planes, _wrap = images(9)
    cfg = G.CodecConfig(1, 0, 2, None)
    streams = [G.compress(im, cfg) for im in u16] * 2
    ref = JS.decode_batch_sharded(streams, cfg)
    for devices in (["cpu"], ["cpu", "cpu"]):
        out = TS.decode_batch_sharded(streams, cfg, devices=devices)
        assert all(np.array_equal(a, b) for a, b in zip(out, ref))
    out = TS.decode_batch_sharded(streams, cfg, devices=["cpu", "cpu"],
                                  backend="native")
    assert all(np.array_equal(a, b) for a, b in zip(out, ref))


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
           sys.argv[5])
