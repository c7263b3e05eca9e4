"""The port's multi-device and multi-rank layer against the JAX package's,
on the CPU, exact: device_compress(mesh=...) (both paths, any shard count)
against the JAX call under its 8-device mesh and the host codec;
multichip_step and dryrun_multichip over gloo ranks; sharded
decode_streams_lanes against the unsharded call and the JAX scan.

The rank functions at the top run in spawned processes, which import this
module by name: jax and the JAX package are imported inside the tests, so
that a rank loads neither."""

import os
import subprocess
import time

import numpy as np
import pytest
import torch

from avrecode_tpu_torch import codec, graft_entry
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.ops import lane_decoder as tld
from avrecode_tpu_torch.ops.estimator import stream_bytes
from avrecode_tpu_torch.parallel import mesh as tmesh
from avrecode_tpu_torch.parallel import ranks as tmh
from avrecode_tpu_torch.parallel import pipeline as tpipe
from avrecode_tpu_torch.parallel.pipeline import device_compress, make_mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")
GEN = os.path.join(ROOT, "tools", "genvideo")
B = 1024


def _step_rank(rank, world, device, arrays):
    """multichip_step on one rank; returns its rows and the total."""
    out, lens, total = tpipe.multichip_step(*arrays, device=device)
    return out, lens, total


def _sleep_rank(rank, world, device):
    if rank == 1:
        time.sleep(600)


def _clip():
    path = os.path.join(DATA, "rt_gop.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "192", "160", "12", "30", "4", "1", "26", "9", "1"],
            check=True, capture_output=True,
        )
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


@pytest.mark.parametrize("scope", ["gop", "slice"])
def test_device_compress_mesh_matches_jax_and_host(scope):
    """The mirror of tests/test_multichip_e2e.py through the port."""
    import jax

    from avrecode_tpu.parallel import pipeline as jpipe

    assert len(jax.devices()) >= 8, "needs the 8-device virtual mesh (conftest)"
    data = _clip()
    port = device_compress(data, mesh=make_mesh(8, device="cpu"), scope=scope,
                           substream_bins=B)
    assert port == jpipe.device_compress(data, mesh=jpipe.make_mesh(8),
                                         scope=scope, substream_bins=B)
    assert port == codec.compress(data, scope=scope, substream_bins=B)
    assert codec.decompress(port) == data
    assert native.decompress(port) == data


def _filled(stats):
    """The stats keys that a call filled (every key is there from the
    start)."""
    return {k for k, v in stats.items() if v}


@pytest.mark.parametrize("n", [1, 2, 3, 8, "traces + 1"])
def test_mesh_lane_any_shard_count(n):
    """Any shard count gives the bytes of the call without a mesh, and
    fills the same stats: counts that do not divide the traces, and more
    shards than traces."""
    data = _clip()
    *_, traces, _ = tpipe.extract_traces(data, scope="gop", want_slots=False)
    if n == "traces + 1":
        n = len(traces) + 1
    one, meshed = {}, {}
    want = device_compress(data, scope="gop", substream_bins=B, device="cpu",
                           stats=one)
    assert device_compress(data, mesh=make_mesh(n, device="cpu"), scope="gop",
                           substream_bins=B, stats=meshed) == want
    assert _filled(meshed) == _filled(one)
    assert meshed["bins"] == one["bins"]
    assert meshed["dispatches"] == min(n, len(traces))


def test_mesh_est_matches_native():
    """The est path over a mesh: the host codec's bytes, and the stats of
    the call without a mesh, every shard counting its groups."""
    data = _clip()
    one, meshed = {}, {}
    out = device_compress(data, mesh=make_mesh(2, device="cpu"), scope="slice",
                          substream_bins=0, stats=meshed)
    assert out == native.compress(data, scope="slice")
    assert native.decompress(out) == data
    assert device_compress(data, scope="slice", substream_bins=0,
                           device="cpu", stats=one) == out
    assert _filled(meshed) == _filled(one)
    for key in ("bins", "est_traces", "est_stored"):
        assert meshed[key] == one[key], key
    assert (one["est_launches"], meshed["est_launches"]) == (1, 2)


class _Trace:
    """A trace as the packers read it: arrays and a length."""

    def __init__(self, rng, T, NS=16):
        self.slots = rng.randint(0, NS, T).astype(np.int32)
        self.bits = rng.randint(0, 2, T).astype(np.uint8)
        self.pcabs = rng.randint(0, 0xFFFF, T).astype(np.uint16)
        self.limits = rng.randint(0x10, 0x100, NS).astype(np.int32)
        self.cls = rng.randint(0, tec.N_CLS, NS).astype(np.int32)

    def __len__(self):
        return len(self.slots)


def _short_traces(seed, n):
    """n synthetic traces of ragged lengths (0 and 1 among them)."""
    rng = np.random.RandomState(seed)
    return [_Trace(rng, [0, 1, 40][i] if i < 3 else int(rng.randint(2, 48)))
            for i in range(n)]


@pytest.mark.parametrize("n", [1, 3, 8, 20])
def test_mesh_est_any_shard_count(n):
    traces = _short_traces(5, 13)
    want = tec.encode_traces_est(traces, device="cpu")
    assert tec.encode_traces_est(traces, mesh=make_mesh(n, device="cpu")) == want


def test_mesh_and_device_together_raise():
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh or device"):
        device_compress(b"x", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="mesh or device"):
        tlc.encode_traces_lanes([], 64, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="mesh or device"):
        tec.encode_traces_est([], device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="mesh or device"):
        tld.decode_streams_lanes([], np.zeros((0, 4), int), [], device="cpu",
                                 mesh=mesh)
    with pytest.raises(ValueError, match="at least one shard"):
        device_compress(b"x", mesh=())
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, device="cpu")


def test_run_sharded_takes_turns():
    """The shard loop runs a dispatch that yields (between its groups) a
    step a shard in turns, so that no shard's wait holds back another's
    dispatch, and collects every shard in order; a plain dispatch runs
    once, and no items still make one empty shard on the first device."""
    log = []

    def dispatch(lo, hi, dev):
        for i in range(lo, hi):
            log.append(i)
            yield
        return lo, hi

    mesh = make_mesh(3, device="cpu")
    assert tmesh.run_sharded(7, mesh, dispatch, list) == [[0, 3], [3, 6],
                                                          [6, 7]]
    assert log == [0, 3, 6, 1, 4, 2, 5]
    assert tmesh.run_sharded(0, mesh, lambda lo, hi, dev: (dev, lo, hi),
                             list) == [[torch.device("cpu"), 0, 0]]


def test_make_mesh_and_shard_ranges(monkeypatch):
    assert make_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
    assert make_mesh(device="cpu") == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1) == (torch.device("cuda", 0),)
    assert make_mesh(4, device="cuda:1") == (torch.device("cuda", 1),) * 4
    with pytest.raises(RuntimeError, match="no CUDA device for 1 of the 3"):
        make_mesh(3)
    # the layout of an array padded to a multiple of n and cut evenly
    for n_rows in range(0, 20):
        for n in range(1, 9):
            ranges = tmesh.shard_ranges(n_rows, n)
            per = -(-n_rows // n)
            assert len(ranges) == n
            assert ranges == [(min(i * per, n_rows), min((i + 1) * per, n_rows))
                              for i in range(n)]
            assert sum(hi - lo for lo, hi in ranges) == n_rows


def test_backend_rule(monkeypatch):
    """nccl when every rank owns a card, gloo when ranks share one or the
    CPU is asked for; rank r uses cuda:{r % device_count}."""
    assert tmh.pick_backend(4, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmh.pick_backend(2) == "nccl"
    assert tmh.pick_backend(1, "cuda:0") == "nccl"
    assert tmh.pick_backend(3) == "gloo"
    assert tmh.pick_backend(2, "cuda:0") == "gloo"
    assert [tmh.rank_device(None, r) for r in range(3)] == [
        torch.device("cuda", 0), torch.device("cuda", 1),
        torch.device("cuda", 0)]
    assert tmh.rank_device("cuda:1", 0) == torch.device("cuda", 1)
    assert tmh.rank_device("cpu", 5) == torch.device("cpu")
    # ranks that share a card need a compute mode that admits them
    monkeypatch.setattr(tmh, "compute_mode", lambda index=0: "Exclusive_Process")
    assert tmh.check_ranks_fit(2) is None
    with pytest.raises(RuntimeError, match="Exclusive_Process"):
        tmh.check_ranks_fit(3)
    monkeypatch.setattr(tmh, "compute_mode", lambda index=0: "Default")
    assert tmh.check_ranks_fit(3) == "Default"


@pytest.mark.parametrize("world", [2, 4])
def test_multichip_step_matches_jax(world):
    """The ranks' rows, gathered in rank order, equal the JAX
    multichip_step on the 8-device mesh: out, lens and total."""
    import jax

    from avrecode_tpu.ops.estimator_jax import stream_bytes as jstream_bytes
    from avrecode_tpu.parallel import pipeline as jpipe

    S, T, NS = 16, 64, 16
    rng = np.random.RandomState(0)
    slots = rng.randint(0, NS, (S, T)).astype(np.int32)
    bits = rng.randint(0, 2, (S, T)).astype(np.int32)
    pcabs = rng.randint(0, 0xFFFF, (S, T)).astype(np.int32)
    limits = np.full((S, NS), 0x60, np.int32)
    valid = np.ones((S, T), np.int32)
    valid[3, 40:] = 0
    cls = rng.randint(0, tec.N_CLS, (S, NS)).astype(np.int32)
    arrays = (slots, bits, pcabs, limits, valid, cls)

    reports = tmh.run_ranks(_step_rank, world, (arrays,), device="cpu",
                            timeout=240)
    assert [r["backend"] for r in reports] == ["gloo"] * world
    got, got_lens = [], []
    for out, lens, _ in (r["result"] for r in reports):
        assert out.shape[0] == lens.shape[0] == S // world
        got += [stream_bytes(out[i], lens[i]) for i in range(len(lens))]
        got_lens += lens.tolist()

    assert len(jax.devices()) >= 8
    jout, jlens, jtotal = jpipe.multichip_step(jpipe.make_mesh(8), *arrays)
    jout, jlens = np.asarray(jout), np.asarray(jlens)
    assert got_lens == jlens.tolist()
    assert got == [jstream_bytes(jout[i], jlens[i]) for i in range(S)]
    assert [r["result"][2] for r in reports] == [int(jtotal)] * world


def test_multichip_step_needs_divisible_rows():
    arrays = tuple(np.zeros((3, 4), np.int32) for _ in range(6))
    with pytest.raises(RuntimeError, match="do not divide over 2 ranks"):
        tmh.run_ranks(_step_rank, 2, (arrays,), device="cpu", timeout=120)


def test_dryrun_multichip_cpu():
    reports = graft_entry.dryrun_multichip(8, device="cpu", timeout=300)
    results = [r["result"] for r in reports]
    assert [r["backend"] for r in reports] == ["gloo"] * 8
    assert all(r["grid"] == (2, 4) and r["device"] == "cpu" for r in results)
    assert len({r["total"] for r in results}) == 1
    offsets = [r["offset"] for r in results]
    assert offsets[0] == 0 and offsets == sorted(offsets)
    assert offsets[-1] < results[0]["total"]
    # on the CPU the wrapper runs its plain version and counts no launch
    assert all(r["launches"] == 0 for r in results)


def test_dryrun_multichip_odd_and_single():
    """An odd count is a (1, n) grid; one rank is a grid of its own."""
    for n in (3, 1):
        reports = graft_entry.dryrun_multichip(n, device="cpu", timeout=300)
        assert [r["result"]["grid"] for r in reports] == [(1, n)] * n


def test_dryrun_failing_rank_raises_within_its_limit():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 failed") as info:
        graft_entry.dryrun_multichip(4, device="cpu", timeout=240,
                                     _fail_rank=2)
    assert "rank 2 was asked to fail" in str(info.value)
    assert time.monotonic() - t0 < 120


def test_hanging_rank_is_killed_at_the_time_limit():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] did not finish within 15 s"):
        tmh.run_ranks(_sleep_rank, 2, device="cpu", timeout=15)
    assert time.monotonic() - t0 < 90


@pytest.mark.parametrize("n", [3, 8])
def test_decode_streams_lanes_mesh(n):
    """Lanes split over the mesh decode to the unsharded call's bits, the
    JAX scan's, and the bits that went in."""
    from avrecode_tpu.ops import lane_decoder as jld

    *_, traces, _ = tpipe.extract_traces(_clip(), scope="gop")
    bitp1, lens, _ = tlc.split_lanes([t for t in traces if len(t)], 512)
    prob = tlc.from_numpy_problem(*tlc.pack_compact(bitp1, lens, pad_lanes=1),
                                  "cpu")
    raw = (t.numpy() for t in tlc.lane_encode(*prob))
    streams = tlc.finalize_lanes(*raw, lens)
    p1s = bitp1 & 0xFFFF
    got = tld.decode_streams_lanes(streams, p1s, lens,
                                   mesh=make_mesh(n, device="cpu")).numpy()
    whole = tld.decode_streams_lanes(streams, p1s, lens, device="cpu").numpy()
    np.testing.assert_array_equal(got, whole)
    np.testing.assert_array_equal(
        got, np.asarray(jld.decode_streams_lanes(streams, p1s, lens)))
    mask = np.arange(bitp1.shape[1])[None, :] < lens[:, None]
    np.testing.assert_array_equal(got, ((bitp1 >> 16) & 1) * mask)
