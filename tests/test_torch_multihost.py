"""tests/test_multihost.py through the port: processes under
init_distributed (torch.distributed, gloo on the CPU) compress and
decompress their GOP ranges, gather the fragments and stitch them; the
results equal the single-process containers of both packages, byte for
byte.  The rank functions run in spawned processes, which import this
module by name: the JAX package is imported inside the tests only."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.parallel import multihost, ranks

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "data")
GEN = os.path.join(ROOT, "tools", "genvideo")
CLIPS = ["rt_ctr.mkv", "mbaff_b.mkv", "mid.mp4"]  # 2, 4 and 6 GOPs

# One process of a pair started by hand, as a deployment would start it:
# argv = rank, rendezvous (a full init method), mode, clip, output path.
WORKER = r"""
import sys
rank, coord, mode, clip, out = sys.argv[1:]
rank = int(rank)
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.parallel import multihost
backend = multihost.init_distributed(coord, 2, rank, device="cpu")
assert backend == "gloo", backend
data = open(clip, "rb").read()
if mode == "compress":
    # each process recodes ONLY its GOP range; the fragments travel to
    # every process
    frag = multihost.compress_sharded(data, rank, 2, threads=1)
    result = multihost.stitch(multihost.allgather_bytes(frag))
else:
    blob = native.compress(data, scope="gop")
    frag = multihost.decompress_sharded(blob, rank, 2, threads=1)
    frags = multihost.allgather_bytes(frag)
    assert all(len(f) > 0 for f in frags), "both shards must decode work"
    result = multihost.stitch_decompressed(frags)
open(out + str(rank), "wb").write(result)
multihost.shutdown_distributed()
print(f"proc {rank} OK bytes={len(result)}")
"""


def _clip_path(name):
    path = os.path.join(DATA, name)
    if name == "mid.mp4" and not os.path.exists(path):
        subprocess.run(
            [GEN, path, "640", "480", "120", "30", "24", "1", "26", "7", "1"],
            check=True, capture_output=True,
        )
    return path


def _read(name):
    with open(_clip_path(name), "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


def _run_pair(mode, clip, tmp_path):
    """Both processes' results (they must agree), or a failure with the
    failing process's output."""
    # a file rendezvous under the test's own directory: no port to pick,
    # so no race with another worker's bind-and-close
    coord = f"file://{tmp_path / 'rendezvous'}"
    out = str(tmp_path / "result")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(i), coord, mode,
             _clip_path(clip), out],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    try:
        for i, p in enumerate(procs):
            text, _ = p.communicate(timeout=240)
            assert p.returncode == 0, f"proc {i} failed:\n{text[-3000:]}"
    finally:
        for p in procs:
            p.kill()
    results = []
    for i in range(2):
        with open(out + str(i), "rb") as f:
            results.append(f.read())
    assert results[0] == results[1]
    return results[0]


@pytest.mark.parametrize("clip", CLIPS)
def test_two_process_stitched_container(clip, tmp_path):
    """Two processes each compress their GOP shard, the fragments are
    gathered, and the stitched container is byte-identical to the
    single-process container of the port and of the JAX package."""
    from avrecode_tpu.host import native as jnative

    data = _read(clip)
    st = _run_pair("compress", clip, tmp_path)
    assert st == native.compress(data, scope="gop")
    assert st == jnative.compress(data, scope="gop")
    assert native.decompress(st) == data


@pytest.mark.parametrize("clip", CLIPS)
def test_two_process_sharded_decompress(clip, tmp_path):
    """Two processes each decompress their GOP-group range of the
    container; concatenation reproduces the original bit-exactly."""
    assert _run_pair("decompress", clip, tmp_path) == _read(clip)


@pytest.mark.parametrize("clip", CLIPS)
def test_sharded_single_process(clip):
    """compress_sharded / decompress_sharded without a process group: any
    process count's stitched fragments equal the whole result, including
    empty shards (more processes than GOPs) and the non-gop-scope
    fallback; and they equal the JAX package's fragments."""
    from avrecode_tpu.parallel import multihost as jmh

    data = _read(clip)
    blob = native.compress(data, scope="gop")
    n_gops = native.gop_count(data)
    for nproc in (1, 2, 3, 7):
        frags = [multihost.compress_sharded(data, i, nproc)
                 for i in range(nproc)]
        assert frags == [jmh.compress_sharded(data, i, nproc)
                         for i in range(nproc)]
        assert multihost.stitch(frags) == blob == jmh.stitch(frags)
        assert [f == b"" for f in frags] == [
            lo >= hi for lo, hi in multihost.shard_gop_ranges(n_gops, nproc)]
        outs = [multihost.decompress_sharded(blob, i, nproc)
                for i in range(nproc)]
        assert outs == [jmh.decompress_sharded(blob, i, nproc)
                        for i in range(nproc)]
        assert multihost.stitch_decompressed(outs) == data
    blob2 = native.compress(data, scope="stream")
    outs = [multihost.decompress_sharded(blob2, i, 2) for i in range(2)]
    assert outs == [data, b""]


@pytest.mark.parametrize("n", range(1, 9))
def test_shard_gop_ranges_matches_jax(n):
    from avrecode_tpu.parallel import multihost as jmh

    for n_gops in range(0, 40):
        assert (multihost.shard_gop_ranges(n_gops, n)
                == jmh.shard_gop_ranges(n_gops, n))


def _collectives_rank(rank, world, device):
    """What the ranks exchange, in one process group: the metrics
    reduction, the fragment gather (an empty payload among them), the
    ("host", "dp") grid with its sub-groups, and the neighbour-hop scan."""
    rng = np.random.RandomState(100 + rank)
    metrics = (rng.rand(5) * 1e6).astype(np.float32)
    psum = multihost.global_metrics_psum(metrics)
    payload = bytes(range(rank * 7 % 256)) * rank  # rank 0 sends nothing
    gathered = multihost.allgather_bytes(payload)
    grid = multihost.mesh_all_hosts(dp_per_host=2)
    dp_scan = ranks.group_excl_scan(rank + 1, *grid.group("dp"))
    host_scan = ranks.group_excl_scan(10 * (rank + 1), *grid.group("host"))
    flat = multihost.mesh_all_hosts()
    world_scan = ranks.group_excl_scan(rank + 1, *flat.group("dp"))
    return {"metrics": metrics, "psum": psum, "gathered": gathered,
            "grid": grid.ranks.tolist(), "place": (grid.row, grid.col),
            "dp_scan": dp_scan, "host_scan": host_scan,
            "world_scan": world_scan, "flat": flat.ranks.tolist(),
            "dp_size": dist.get_world_size(grid.row_group)}


def test_collectives_over_six_ranks():
    world = 6
    reports = ranks.run_ranks(_collectives_rank, world, device="cpu",
                              timeout=240)
    res = [r["result"] for r in reports]
    # the reduction is the sum of the gathered rows in rank order, bit for
    # bit, the same on every rank
    want = np.stack([r["metrics"] for r in res]).sum(axis=0)
    assert want.dtype == np.float32
    for r in res:
        assert r["psum"].dtype == np.float32
        assert r["psum"].tobytes() == want.tobytes()
    payloads = [bytes(range(k * 7 % 256)) * k for k in range(world)]
    assert payloads[0] == b"" and all(r["gathered"] == payloads for r in res)
    for k, r in enumerate(res):
        assert r["grid"] == [[0, 1], [2, 3], [4, 5]]
        assert r["flat"] == [list(range(world))]
        assert r["place"] == divmod(k, 2) and r["dp_size"] == 2
        row, col = divmod(k, 2)
        assert r["dp_scan"] == sum(j + 1 for j in range(row * 2, k))
        assert r["host_scan"] == sum(10 * (j + 1) for j in range(col, k, 2))
        assert r["world_scan"] == sum(j + 1 for j in range(k))


def _bad_grid_rank(rank, world, device):
    multihost.mesh_all_hosts(dp_per_host=2)


def test_mesh_all_hosts_rejects_a_ragged_world():
    with pytest.raises(RuntimeError, match="3 ranks are no multiple of"):
        ranks.run_ranks(_bad_grid_rank, 3, device="cpu", timeout=120)
