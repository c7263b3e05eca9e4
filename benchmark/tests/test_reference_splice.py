"""The reference: a recording's container made from its units' containers
equals the reference codec over the whole stream, and the reference equals
the port's host codec on the small test GOPs and a recording spliced from
them."""

import pytest

from conftest import BENCH, DATA, TINY_GOPS

from benchmark.reference import expected

B = 16384


def _gops():
    return [(DATA / g).read_bytes() for g in TINY_GOPS]


def test_splice_equals_the_codec_over_the_whole_stream():
    gops = _gops()
    units = [expected.compress(g, B) for g in gops]
    for seq in ([0], [1, 0], [2, 0, 1, 1, 0]):
        whole = b"".join(gops[i] for i in seq)
        assert expected.splice([units[i] for i in seq]) == \
            expected.compress(whole, B)


def test_reference_equals_the_ports_host_codec():
    from avrecode_tpu_torch import codec

    gops = _gops()
    draw = gops + [gops[1] + gops[0]]
    for data in draw:
        assert expected.compress(data, B) == codec.compress(
            data, scope="gop", substream_bins=B)


def test_containers_are_computed_once_and_kept():
    data = {"a": _gops()[1],
            "b": _gops()[0]}
    first = expected.containers(data, B, workers=2)
    for name, blob in data.items():
        assert first[name] == expected.compress(blob, B)
        assert expected._cache_path(blob, B, expected.source_key()).exists()
    assert expected.containers(data, B) == first


def test_parse_rejects_what_is_not_a_container():
    with pytest.raises(ValueError):
        expected.parse(b"not a container")


def test_the_camera_pool_takes_the_programs_native_route():
    """The reference is a frozen copy of the port's pure-Python codec, so a
    file that the program sends to its Python parser, or to its host codec
    (a file without traces), would be checked against a copy of the code
    that made it.  Every GOP of the camera pool is taken by the native
    extractor and has traces for the lane coder."""
    import json
    from avrecode_tpu_torch.host import native
    from avrecode_tpu_torch.parallel import pipeline

    from benchmark.harness import inputs

    assert native.available()
    config = json.loads((BENCH / "configs" / "camera_1080p.json").read_text())
    for name in config["pool"]["files"]:
        data = (BENCH / config["pool"]["dir"] / name).read_bytes()
        for unit in inputs.annexb_units(data):
            *_, traces, stats = pipeline.extract_traces(
                unit, scope="gop", want_slots=False)
            assert stats["native"] and traces, name
