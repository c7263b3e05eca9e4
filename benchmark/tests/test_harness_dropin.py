"""A configuration, a traffic mix, a per-layer metric and a cell are each
added by adding files and entries only: the harness finds them by name,
and no harness file names a cell, configuration, mix or metric."""

import json
import re

import pytest

from conftest import BENCH, DATA, ROOT, make_base, spec_of, TINY_GOPS

from benchmark.harness import drive


def test_harness_names_no_cell_config_mix_or_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [c["name"] for c in bench["workloads"] + bench["configs"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["traffic"] for c in bench["workloads"]]
    for path in (BENCH / "harness").glob("*.py"):
        text = path.read_text()
        for name in names:
            assert not re.search(rf"[\"']{re.escape(name)}[\"']", text), \
                (path.name, name)


def test_new_config_mix_metric_and_cell_by_files_alone(tmp_path):
    base = make_base(
        tmp_path, ["dropped.one_by_one"],
        {"dropped": (DATA, TINY_GOPS[:2],
                     {"kind": "recordings", "recording_gops": [[2], [4, 2]]},
                     None)})
    (base / "traffic" / "one_by_one.json").write_text(json.dumps(
        {"unit": "file", "entry": "file"}))
    (base / "metrics" / "files_done.py").write_text(
        "def read(rec):\n    return len(rec['units']) or None\n")
    bench = json.loads((base / "BENCHMARK.json").read_text())
    bench["per_layer"].append(
        {"name": "files_done", "unit": "files", "better": "higher",
         "source": "host_clock", "layer": "corpus driver",
         "moves": "compress_mb_s"})
    (base / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = spec_of(base)
    assert spec.mix("one_by_one")["unit"] == "file"
    assert spec.config("dropped")["job"]["recording_gops"] == [[2], [4, 2]]
    assert "files_done" in [m["name"] for m in
                            spec.metrics("dropped.one_by_one", True)]
    rec, checks = drive.run_cell(spec, "dropped.one_by_one", 77, 0.05,
                                 False, device="cpu")
    assert drive.correct(checks)
    assert spec.reader("files_done").read(rec) == len(rec["units"]) >= 1


def test_every_metric_has_a_reader_that_declares_its_entry():
    from benchmark.harness.spec import Spec
    spec = Spec()
    for m in spec.data["end_to_end"]:
        reader = spec.reader(m["name"])
        assert callable(reader.read)
        assert (reader.MOVES, reader.SOURCE) == (m["name"], m["source"])
    for m in spec.data["per_layer"]:
        reader = spec.reader(m["name"])
        assert callable(reader.read)
        assert (reader.LAYER, reader.MOVES, reader.SOURCE) == (
            m["layer"], m["moves"], m["source"]), m["name"]


@pytest.mark.parametrize("mix", [
    {"unit": "file", "entry": "file", "loop": "open"},
    {"unit": "job", "entry": "corpus", "callers": 4},
    {"unit": "request", "entry": "file"},
    {"unit": "file", "entry": "restore"},
])
def test_a_mix_the_window_cannot_send_is_refused(tmp_path, mix):
    base = make_base(tmp_path, [], {})
    (base / "traffic" / "other.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError):
        spec_of(base).mix("other")


def test_the_repositorys_mixes_are_read():
    from benchmark.harness.spec import Spec
    spec = Spec()
    for cell in spec.data["workloads"]:
        assert spec.mix(cell["traffic"])["unit"] in ("job", "file")
