"""tools/gpu_verify.py's launch accounting against the path the port takes
on the card: for every compress check of its table (CHECKS), the upload
form that pack_lanes gives the check's clip at the tool's B implies a
fused launcher that the check accepts; the off-image check's lanes keep the
u16 form, whose launcher is the one that check requires, and code on the
CPU to the host finalize's streams.  Exact: forms, names and bytes."""

import os

import numpy as np
import pytest

from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import lane_coder as tlc
from tools import gpu_verify as gv

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
# the tool's checks that compress through the main path
LANE_CHECKS = ["lane_coder_gop_byte_identical",
               "device_container_roundtrips_both_decoders",
               "mesh_lane_coder_byte_identical",
               "cavlc_lane_coder_byte_identical"]


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _launcher(p1):
    """The fused launcher that a dispatch group of p1's form goes to."""
    return ("lane_encode_streams_idx" if tlc.index_form(p1)
            else "lane_encode_streams")


def _accepts(name, launcher):
    """Would check `name` pass on one launch of `launcher` and none of the
    other kernels it counts?"""
    _, kernels, rule = gv.CHECKS[name]
    return gv.launches_ok(rule, {k: int(k == launcher) for k in kernels})


def test_lane_checks_are_the_compress_checks():
    """The checks that count a fused launcher are LANE_CHECKS and the
    off-image check."""
    assert [name for name, (_, kernels, _) in gv.CHECKS.items()
            if set(kernels) & set(gv.FUSED)] == [
                *LANE_CHECKS, "off_image_lanes_take_u16"]


@pytest.mark.parametrize("name", LANE_CHECKS)
def test_lane_check_accepts_the_launcher_of_its_form(name):
    """pack_lanes on the check's clip (native traces, gop scope, as
    device_compress packs them) gives a form whose launcher the check
    accepts."""
    if not native.available():
        pytest.skip("native library not built")
    clip = gv.CHECKS[name][0]
    traces = native.extract(_read(clip), "gop", want_slots=False)[3]
    p1 = tlc.pack_lanes(traces, gv.B)[0]
    assert tlc.index_form(p1)  # native traces lie on the squash grid
    assert _accepts(name, _launcher(p1))


@pytest.mark.parametrize("clip", [gv.CLIP, gv.SMALL, gv.CAVLC])
def test_verify_clips_take_a_launcher_every_lane_check_accepts(clip):
    """The three clips the tool reads, the small one included (the command
    line may give it as the main clip), all pack to the index form, which
    every compress check accepts."""
    if not native.available():
        pytest.skip("native library not built")
    traces = native.extract(_read(clip), "gop", want_slots=False)[3]
    launcher = _launcher(tlc.pack_lanes(traces, gv.B)[0])
    assert launcher == "lane_encode_streams_idx"
    assert all(_accepts(name, launcher) for name in LANE_CHECKS)


def test_off_image_check_requires_the_u16_launcher():
    """The off-image lanes keep the u16 form; the check passes on its
    launcher alone and fails where the index launcher ran."""
    if not native.available():
        pytest.skip("native library not built")
    name = "off_image_lanes_take_u16"
    p1u16, bitw, lens = gv.off_image_lanes(_read(gv.CHECKS[name][0]))
    chosen = tlc.choose_form(p1u16, lens)
    assert _launcher(chosen) == "lane_encode_streams"
    assert _accepts(name, "lane_encode_streams")
    assert not _accepts(name, "lane_encode_streams_idx")
    assert not gv.launches_ok("first", {"lane_encode_streams": 1,
                                        "lane_encode_streams_idx": 1})


def test_off_image_check_on_cpu():
    """The check's own comparison, on the CPU route of the fused wrapper:
    every valid p1 off the image, and the streams equal the host
    finalize's."""
    if not native.available():
        pytest.skip("native library not built")
    data = _read(gv.CHECKS["off_image_lanes_take_u16"][0])
    p1u16, _, lens = gv.off_image_lanes(data)
    live = np.arange(p1u16.shape[1])[None, :] < lens[:, None]
    assert live.sum() > 100_000
    assert not tlc._squash_tables()[2][p1u16[live]].any()
    assert gv.off_image_check(data, "cpu")


@pytest.mark.parametrize("rule,launches,ok", [
    ("each", {"a": 1, "b": 2}, True), ("each", {"a": 1, "b": 0}, False),
    ("each", {}, True), ("any", {"a": 0, "b": 3}, True),
    ("any", {"a": 0, "b": 0}, False), ("first", {"a": 1, "b": 0}, True),
    ("first", {"a": 0, "b": 1}, False), ("first", {"a": 2, "b": 1}, False)])
def test_launch_rules(rule, launches, ok):
    assert gv.launches_ok(rule, launches) is ok


def test_every_kernel_of_the_table_has_a_wrapper():
    for _, kernels, rule in gv.CHECKS.values():
        assert rule in ("each", "any", "first")
        for k in kernels:
            assert gv._kernel(k).__name__ == k
