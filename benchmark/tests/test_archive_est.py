"""The archive configuration (configs/archive_est.json): v1 containers at
gop scope, substream_bins 0, the program's est path.

On the CPU, a tiny configuration of the three small test GOPs at the
archive's settings: a sound serial run is `correct`, and the control, the
program at 16,384 bins a lane (the v2 lane container, which roundtrips but
is not the stated container), mismatches every recording; the reference's
v1 containers equal the port's host codec and splice as the whole stream's;
the cell's four readers read a traced run and give None where the record
lacks their source.  test_control_on_card runs the control at the cell's
own size (python -m pytest -m cuda benchmark/tests)."""

import json

import pytest

from conftest import BENCH, DATA, TINY_GOPS, make_base, spec_of

from benchmark.harness import drive
from benchmark.harness.spec import Spec
from benchmark.reference import expected

CELL = "archive_est.serial"
TINY = "tiny_archive.serial"
CONTROL = {"substream_bins": 16384}
READERS = ["est_kernel_s_per_mb.archive_est", "device_idle_pct.archive_est",
           "extract_share_pct.archive_est", "host_cpu_s_per_mb.archive_est"]
TRACED = READERS[:3]  # the device trace's and the spans' readers


@pytest.fixture
def archive_base(tmp_path):
    """One recording of the three small test GOPs, sent one file a call,
    at the archive configuration's settings."""
    base = make_base(
        tmp_path, [TINY],
        {"tiny_archive": (DATA, TINY_GOPS,
                          {"kind": "recordings", "recording_gops": [[3]]},
                          1)})
    path = base / "configs" / "tiny_archive.json"
    config = json.loads(path.read_text())
    config["settings"] = json.loads(
        (BENCH / "configs" / "archive_est.json").read_text())["settings"]
    path.write_text(json.dumps(config))
    return base


def _gops():
    return [(DATA / g).read_bytes() for g in TINY_GOPS]


def test_the_configuration_is_camera_footage_as_v1_containers():
    spec = Spec()
    archive, camera = spec.config("archive_est"), spec.config("camera_1080p")
    assert archive["settings"] == {"scope": "gop", "substream_bins": 0}
    assert archive["pool"] == camera["pool"]
    assert archive["job"] == camera["job"]
    assert archive["reduced"] == ["recording_gops"]
    cell = spec.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "archive_est", "serial", 1)


def test_sound_run_is_correct_and_the_control_is_not(archive_base):
    """The sound run untraced (the plain est loop under the profiler would
    record every op of its ~28K steps); the control traced, and the cell's
    readers read it, where its untraced record gives them nothing."""
    spec = spec_of(archive_base)
    sound, checks = drive.run_cell(spec, TINY, 13, 0.05, False, device="cpu")
    assert drive.correct(checks), checks
    assert checks["files_checked"]["value"] >= 1
    rec, checks = drive.run_cell(spec, TINY, 13, 0.05, True, device="cpu",
                                 settings=CONTROL)
    assert not drive.correct(checks)
    assert checks["mismatched_files"]["value"] == \
        checks["files_checked"]["value"] >= 1
    for name in READERS:
        value = spec.reader(name).read(rec)
        assert isinstance(value, float) and value >= 0, (name, value)
    for name in TRACED:
        # an untraced record holds no device trace and no spans
        assert spec.reader(name).read(sound) is None, name
    # the process CPU is read in every run, and is missing from no record
    cpu = spec.reader(READERS[3])
    assert isinstance(cpu.read(sound), float) and cpu.read(sound) > 0
    assert cpu.read({k: v for k, v in sound.items() if k != "cpu_s"}) is None


def test_est_kernel_reader_sums_the_kernels_launches():
    """Device seconds of every est_encode_kernel instantiation over the
    window's finished MB; other operations are left out."""
    reader = Spec().reader(READERS[0])
    rec = {"units": [{"t0": 0.0, "t1": 9.0, "bytes": 23_000_000,
                      "files": 1, "error": None},
                     {"t0": 9.0, "t1": 9.5, "bytes": 5_000_000, "files": 1,
                      "error": "RuntimeError: x"}],
           "trace": {"busy_s": 7.0, "trace_window_s": 9.5, "ops": {
               "void (anonymous namespace)::est_encode_kernel<true>(int "
               "const*": [2, 4.4],
               "void (anonymous namespace)::est_encode_kernel<false>(int "
               "const*": [1, 2.2],
               "Memcpy HtoD (Pinned -> Device)": [170, 0.6]}}}
    assert reader.read(rec) == pytest.approx(6.6 / 23.0)
    rec["trace"]["ops"] = {}
    assert reader.read(rec) == 0.0


def test_readers_are_declared_for_the_archive_cell():
    spec = Spec()
    for name in READERS:
        (m,) = [m for m in spec.data["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "compress_mb_s"
        reader = spec.reader(name)
        assert (reader.LAYER, reader.MOVES, reader.SOURCE) == (
            m["layer"], m["moves"], m["source"])


def test_reference_v1_equals_the_ports_host_codec_and_splices():
    from avrecode_tpu_torch import codec

    gops = _gops()
    units = [expected.compress(g, 0) for g in gops]
    for g, unit in zip(gops, units):
        assert unit == codec.compress(g, scope="gop", substream_bins=0)
        assert expected.parse(unit)[0][3] == 0
    for seq in ([2, 0, 1], [1, 1, 0]):
        whole = b"".join(gops[i] for i in seq)
        assert expected.splice([units[i] for i in seq]) == \
            expected.compress(whole, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4_200_000_001, 4_200_000_002,
                                  4_200_000_003])
def test_control_on_card(card, seed):
    spec = Spec()
    rec, checks = drive.run_cell(spec, CELL, seed, spec.data["run_seconds"],
                                 False, device=card, settings=CONTROL)
    print(f"control {CELL} seed {seed}: {checks}")
    assert not drive.correct(checks)
    assert checks["mismatched_files"]["value"] == \
        checks["files_checked"]["value"] >= 1
