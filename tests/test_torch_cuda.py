"""Tests of the port that need an NVIDIA GPU (marker `cuda`; they skip
where there is none).  This file imports neither JAX nor the JAX package, so it also
runs where only the port's dependencies are installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

The CUDA kernels must equal their plain torch versions exactly (integer
arithmetic, tolerance zero), and the main paths must go through them."""

import os

import numpy as np
import pytest
import torch

from avrecode_tpu_torch import codec
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import lane_coder as tlc
from avrecode_tpu_torch.parallel.pipeline import device_compress
from chip_smoke import EST_CASES, EST_SWEEP
from chip_smoke import est_problem as _est_problem
from chip_smoke import lanes as _problem

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# lane counts that are no multiple of a warp's 16 lanes, widths that are no
# multiple of the kernel's 128-bin tile; chip_smoke.lanes puts lens of 0, 1,
# 127, 128, 129 (and the 8-bin group edges) on the first lanes
@pytest.mark.parametrize("kind, L, B", [
    ("random", 5, 256), ("random", 300, 1024), ("carry", 300, 4096),
    ("random", 130, 16384), ("random", 4, 32768),
    ("random", 1, 32), ("random", 33, 96), ("random", 70, 160),
    ("random", 31, 4128), ("carry", 97, 1184), ("random", 64, 128),
    ("random", 17, 256), ("zero", 40, 512),
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
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    before = tlc.lane_encode.launches
    out = device_compress(data, scope="gop", substream_bins=4096, device=cuda)
    assert tlc.lane_encode.launches > before
    assert out == codec.compress(data, scope="gop", substream_bins=4096)


def test_lane_kernel_rejects_misaligned_p1(cuda):
    p1u16, bitw, lens = tlc.from_numpy_problem(
        *_problem("random", 2, 64, seed=1), cuda)
    flat = torch.zeros(2 * 64 + 1, dtype=torch.uint16, device=cuda)
    view = flat[1:].view(2, 64)  # contiguous, two bytes off the boundary
    with pytest.raises(ValueError, match="16-byte"):
        tlc.lane_encode(view, bitw, lens)


# the first est kernel's cases, then chip_smoke's: slot counts on both sides
# of the shared-memory budget, T under and off the 32-bin tile, valid bins
# only in a tile's tail, one slot hit by every bin, counters at every limit
@pytest.mark.parametrize("kind, S, T, NS", [
    ("random", 33, 1024, 300), ("skew", 8, 2048, 64), ("holes", 16, 1024, 128),
    ("random", 4, 512, 4096), *EST_CASES[4:], EST_SWEEP,
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
    if not native.available():
        pytest.skip("native library not built")
    data = open(os.path.join(DATA, "rt_ctr.mkv"), "rb").read()
    for scope in ("slice", "gop"):
        before = tec.est_encode.launches
        out = device_compress(data, scope=scope, substream_bins=0, device=cuda)
        assert tec.est_encode.launches > before
        assert out == native.compress(data, scope=scope)
