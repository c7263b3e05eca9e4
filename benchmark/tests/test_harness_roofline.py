"""The copied bound arithmetic at the full group [8192, 16384] of real
traces that chip_smoke.py's phase 5 codes: its 10,372,466 stream bytes
(the bytes it logged less the inputs) give 228,582,770 B in the index form
and 295,683,442 B in the u16 form."""

import pytest

from benchmark.harness import roofline

L, B, EMITTED = 8192, 16384, 10_372_466


def test_full_group_bytes_both_forms():
    assert roofline.stream_bytes(L, B, EMITTED, index=True) == 228_582_770
    assert roofline.stream_bytes(L, B, EMITTED, index=False) == 295_683_442


def test_full_group_bound_is_set_by_bytes():
    n_bins = L * B
    ms, by = roofline.launch_bound_ms(L, B, n_bins, EMITTED, index=True)
    assert by == "bytes"
    assert ms == pytest.approx(228_582_770 / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.068, abs=5e-4)
    ops = roofline.lane_ops(roofline.STREAM_IDX_OPS, n_bins, EMITTED)
    assert ops == 12 * n_bins + 10 * EMITTED
