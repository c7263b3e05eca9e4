"""The general generator: seeded jobs, the Annex B splicer, and a spliced
recording through the port's own codec."""

import hashlib
import json

import pytest

from conftest import BENCH, DATA, TINY_GOPS

from benchmark.harness import inputs


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_camera_jobs_are_seeded(tmp_path):
    config = _config("camera_1080p")
    seed = 2 ** 31 + 987654321
    dirs = [tmp_path / d for d in "abc"]
    for d in dirs:
        d.mkdir()
    a = inputs.Jobs(config, BENCH, seed, dirs[0])
    b = inputs.Jobs(config, BENCH, seed, dirs[1])
    other = inputs.Jobs(config, BENCH, seed + 1, dirs[2])
    assert _recordings(a) == _recordings(b)
    assert _recordings(a) != _recordings(other)
    for k in range(2):
        # every seed does the same work, in another order
        assert sorted(len(f.parts) for f in a.job(k)) == \
            sorted(len(f.parts) for f in other.job(k))
        mb = sum(f.size for f in a.job(k)) / 1e6
        assert 30 <= mb <= 40


def _tiny_camera():
    return {"pool": {"dir": str(DATA), "files": TINY_GOPS},
            "job": {"kind": "recordings", "recording_gops": [[3, 6], [9]]},
            "warm_files": 1}


def _recordings(jobs):
    return [(f.key, f.parts, hashlib.sha256(open(f.path, "rb").read())
             .hexdigest()) for k in range(2) for f in jobs.job(k)]


def test_recordings_are_seeded(tmp_path):
    seed = 3 ** 30
    dirs = [tmp_path / d for d in "abc"]
    for d in dirs:
        d.mkdir()
    a = inputs.Jobs(_tiny_camera(), "/", seed, dirs[0])
    b = inputs.Jobs(_tiny_camera(), "/", seed, dirs[1])
    other = inputs.Jobs(_tiny_camera(), "/", seed + 7, dirs[2])
    assert _recordings(a) == _recordings(b)
    assert _recordings(a) != _recordings(other)
    for f in a.job(0) + a.job(1):
        # each unit equally often
        counts = {u: f.parts.count(u) for u in a.units}
        assert len(set(counts.values())) == 1
    assert a.warm_job() == [a.job(0)[0]]


def test_annexb_units_cut_at_each_idr_after_sps_and_pps():
    gops = [(DATA / g).read_bytes() for g in TINY_GOPS]
    assert inputs.annexb_units(gops[0]) == [gops[0]]
    joined = gops[2] + gops[0] + gops[1]
    assert inputs.annexb_units(joined) == [gops[2], gops[0], gops[1]]
    cam = (BENCH / "clips" / "camera" / "cam_gop1.264").read_bytes()
    assert inputs.annexb_units(cam) == [cam]
    with pytest.raises(ValueError):
        inputs.annexb_units(gops[0][40:])


def test_spliced_recording_roundtrips_through_the_ports_codec(tmp_path):
    from avrecode_tpu_torch import codec
    from avrecode_tpu_torch.host import native

    jobs = inputs.Jobs(_tiny_camera(), "/", 12345, tmp_path)
    longest = max(jobs.job(0) + jobs.job(1), key=lambda f: f.size)
    rec = open(longest.path, "rb").read()
    assert len(longest.parts) == 9
    blob = codec.compress(rec, scope="gop", substream_bins=16384)
    assert codec.decompress(blob) == rec
    if native.available():
        assert native.decompress(blob) == rec


def test_an_unknown_kind_of_job_is_refused(tmp_path):
    config = dict(_tiny_camera(), job={"kind": "files", "files": 3})
    with pytest.raises(ValueError):
        inputs.Jobs(config, "/", 1, tmp_path)
