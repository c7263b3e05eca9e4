"""The archive deployment's path on the CPU: a recording spliced from the
benchmark's three small test GOPs through device_compress at gop scope and
substream_bins=0 (the est path, a v1 container), one call, checked against
the JAX package's device pipeline and codec on the same recording, the
native host codec and the benchmark's reference, with the est device
stage's counters (spans.KEYS) held to the traces and streams of the call:
its one group taken to the device as the traces' records.

The plain est loop steps through the longest trace's ~28K bins: ~25 s."""

import os
import sys

import pytest

from avrecode_tpu import codec
from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch import spans
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.ops import est_coder
from avrecode_tpu_torch.parallel import pipeline as tpipe

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
GOPS = [os.path.join(ROOT, "benchmark", "tests", "data", f"gop{i}.264")
        for i in (1, 2, 3)]
EST_SPANS = ("est_pack_s", "est_upload_s", "est_launch_s", "est_collect_s",
             "est_finalize_s")
EST_COUNTS = ("est_launches", "est_traces", "est_padded_bins", "est_stored",
              "est_memory_cuts")


@pytest.fixture(scope="module")
def est_call():
    """One est device_compress call of the spliced recording: (the GOPs,
    the container, its stats, the traces and streams it serialised)."""
    if not native.available():
        pytest.skip("native library not built")
    gops = []
    for path in GOPS:
        with open(path, "rb") as f:
            gops.append(f.read())
    seen = {}
    real = tpipe._serialize

    def spy(scope_id, sps, pps, blocks, traces, streams, substream_bins):
        seen["traces"], seen["streams"] = list(traces), list(streams)
        return real(scope_id, sps, pps, blocks, traces, streams,
                    substream_bins)

    stats = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "_serialize", spy)
        out = tpipe.device_compress(b"".join(gops), scope="gop",
                                    substream_bins=0, device="cpu",
                                    stats=stats)
    return gops, out, stats, seen["traces"], seen["streams"]


def test_container_equals_the_jax_package_on_the_same_recording(est_call):
    gops, out, *_ = est_call
    data = b"".join(gops)
    assert out == jpipe.device_compress(data, scope="gop", substream_bins=0)
    assert out == codec.compress(data, scope="gop", substream_bins=0)


def test_container_is_v1_and_equals_the_host_codec_and_the_reference(
        est_call):
    from benchmark.reference import expected

    gops, out, *_ = est_call
    assert out == native.compress(b"".join(gops), scope="gop")
    assert out == expected.splice([expected.compress(g, 0) for g in gops])
    head = expected.parse(out)[0]
    assert head[3] == 0  # substream_bins: the v1 container


def test_est_counters_pin_the_traces_and_streams(est_call):
    _, _, stats, traces, streams = est_call
    assert set(spans.KEYS) <= set(stats)
    assert len(traces) == len(GOPS)  # one trace a GOP at gop scope
    assert stats["est_traces"] == len(traces)
    # three traces of ~28K bins fill one group of GROUP_BINS
    assert len(traces) * max(map(len, traces)) <= est_coder.GROUP_BINS
    assert stats["est_launches"] == 1 and stats["est_memory_cuts"] == 0
    assert stats["est_wait_s"] == 0  # one group: no kernel before to wait for
    # the group went as its traces' records: no trace's slots, bits or
    # pcabs cached on the host
    assert all(t._slots is None and t._bits is None and t._pcabs is None
               for t in traces)
    assert stats["est_padded_bins"] == len(traces) * max(map(len, traces))
    assert stats["est_padded_bins"] >= stats["bins"] == sum(map(len, traces))
    assert stats["est_stored"] == sum(map(len, streams)) > 0
    # the plain est loop runs inside est_launch
    assert stats["est_launch_s"] > 0


@pytest.mark.parametrize("key", EST_SPANS)
def test_est_spans_are_filled(est_call, key):
    stats = est_call[2]
    assert type(stats[key]) is float and stats[key] >= 0


def test_the_lane_keys_stay_zero_on_the_est_path(est_call):
    stats = est_call[2]
    for k in ("pack_s", "copy_s", "dispatch_s", "upload_s", "collect_s",
              "envelope_s", "dispatches"):
        assert stats[k] == 0, k
    assert stats["trace_bytes"] == 8 * stats["bins"]
    assert all(type(stats[k]) is int for k in EST_COUNTS)
