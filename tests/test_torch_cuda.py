"""Tests of the port that need an NVIDIA GPU (marker `cuda`; they skip
where there is none).  This file imports no JAX, so it also runs where
only the port's dependencies are installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

The CUDA kernels must equal their plain torch versions exactly (integer
arithmetic, tolerance zero), and the main paths must go through them."""

import os

import numpy as np
import pytest
import torch

from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(kind, L, B, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        p1 = rng.integers(1, 1 << 16, (L, B))
        bits = rng.random((L, B)) * 65536 < p1
    else:  # p1 near 0xFFFF, 30% of bins against it: carries, 0xFF runs
        p1 = rng.integers(0xFFF0, 1 << 16, (L, B))
        bits = rng.random((L, B)) > 0.3
    lens = rng.integers(0, B + 1, L).astype(np.int32)
    lens[:4] = [B, 0, 1, B - 1]
    bitw = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    return p1.astype(np.uint16), bitw, lens


@pytest.mark.parametrize("kind, L, B", [
    ("random", 5, 256), ("random", 300, 1024), ("carry", 300, 4096),
    ("random", 130, 16384), ("random", 4, 32768),
])
def test_kernel_matches_plain(cuda, kind, L, B):
    prob = tlc.from_numpy_problem(*_problem(kind, L, B, seed=L + B), cuda)
    before = tlc.lane_encode.launches
    got = tlc.lane_encode(*prob)
    torch.cuda.synchronize()
    assert tlc.lane_encode.launches == before + 1
    for a, b in zip(got, tlc.lane_encode_plain(*prob)):
        assert a.device.type == "cuda" and a.dtype == torch.int32
        assert torch.equal(a, b)


def test_kernel_streams_and_overflow_path(cuda):
    p1u16, bitw, lens = _problem("carry", 40, 2048, seed=9)
    host = tlc.lane_streams_device_compact(p1u16, bitw, lens, "cpu")
    assert tlc.lane_streams_device_compact(p1u16, bitw, lens, cuda) == host
    before = tlc.lane_collect.overflows
    dense = tlc.lane_streams_device_compact(p1u16, bitw, lens, cuda,
                                            bits_per_byte=1000)
    assert tlc.lane_collect.overflows == before + 1
    assert dense == host


def test_main_path_launches_kernel(cuda):
    from avrecode_tpu import codec
    from avrecode_tpu.host import native
    from avrecode_tpu_torch.parallel.pipeline import device_compress

    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    before = tlc.lane_encode.launches
    out = device_compress(data, scope="gop", substream_bins=4096, device=cuda)
    assert tlc.lane_encode.launches > before
    assert out == codec.compress(data, scope="gop", substream_bins=4096)


def _est_problem(kind, S, T, NS, seed):
    """Est problem from a seed: "random" spreads cls over all key classes
    with random halving limits; "skew" is test_pallas.py's carry stress
    (98% ones, one class); "holes" adds invalid bins inside traces."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, NS, (S, T))
    if kind == "skew":
        bits = rng.random((S, T)) < 0.98
        limits = np.full((S, NS), 0x60)
        cls = np.zeros((S, NS))
    else:
        bits = rng.integers(0, 2, (S, T))
        limits = rng.integers(0x10, 0x100, (S, NS))
        cls = rng.integers(0, tec.N_CLS, (S, NS))
    pcabs = rng.integers(0, 1 << 16, (S, T))
    pcabs[:, ::3] = 0  # no CABAC input
    valid = np.ones((S, T))
    valid[0, T - T // 3:] = 0  # ragged tail
    if kind == "holes":
        valid[:, T // 4: T // 4 + 100] = 0
        valid[1::2, ::5] = 0
    return slots, bits, pcabs, limits, valid, cls


@pytest.mark.parametrize("kind, S, T, NS", [
    ("random", 33, 1024, 300), ("skew", 8, 2048, 64), ("holes", 16, 1024, 128),
    ("random", 4, 512, 4096),
])
def test_est_kernel_matches_plain(cuda, kind, S, T, NS):
    prob = tec.from_numpy_traces(*_est_problem(kind, S, T, NS, seed=S + T), cuda)
    before = tec.est_encode.launches
    got = tec.est_encode(*prob)
    torch.cuda.synchronize()
    assert tec.est_encode.launches == before + 1
    for a, b in zip(got, tec.est_encode_plain(*prob)):
        assert a.device.type == "cuda" and a.dtype == torch.int32
        assert torch.equal(a, b)


def test_est_main_path_launches_kernel(cuda):
    from avrecode_tpu.host import native
    from avrecode_tpu_torch.parallel.pipeline import device_compress

    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    for scope in ("slice", "gop"):
        before = tec.est_encode.launches
        out = device_compress(data, scope=scope, substream_bins=0, device=cuda)
        assert tec.est_encode.launches > before
        assert out == native.compress(data, scope=scope)
