"""`correct` has to come out false for the control and for every fault the
timed path can have.

The control is the program run with a cheaper setting than the
configuration states: 8,192 bins a lane in place of 16,384 (twice the
lanes, the step a later change might take for parallelism), which still
roundtrips but breaks the stated guarantee that every container equals the
reference's.  The faults are planted under the harness, in the entry the
window calls: a call that returns its state unchanged (the input itself),
half of a batch left out, and one answer altered where it is produced.
(No cell spans chips, so no exchange between them can be left out.)

The CPU tests run the tiny cells; test_control_on_card runs the control at
each cell's own size on the card (python -m pytest -m cuda benchmark/tests)."""

import pytest

from conftest import spec_of

from benchmark.harness import drive
from benchmark.harness.spec import Spec

CONTROL = {"substream_bins": 8192}


def _run(base, cell, seed=11, **kw):
    spec = spec_of(base)
    rec, checks = drive.run_cell(spec, cell, seed, 0.05, False,
                                 device="cpu", **kw)
    return rec, checks


def _broken(base, cell, fault):
    spec = spec_of(base)
    config = spec.config(spec.cell(cell)["config"])
    real = drive.program_entries(config["settings"], "cpu")

    def corpus(files, stats):
        outs = real["corpus"](files, stats)
        if fault == "unchanged":
            return [open(f.path, "rb").read() for f in files]
        if fault == "half":
            return outs[: len(outs) // 2]
        if fault == "altered":
            blob = bytearray(outs[-1])
            blob[len(blob) // 2] ^= 0x01
            outs[-1] = bytes(blob)
        return outs

    return {"corpus": corpus, "file": real["file"]}


@pytest.mark.parametrize("cell", ["tiny_camera.batch", "tiny_camera.serial"])
def test_sound_runs_are_correct_and_the_control_is_not(tiny_base, cell):
    _, checks = _run(tiny_base, cell)
    assert drive.correct(checks)
    _, checks = _run(tiny_base, cell, settings=CONTROL)
    assert not drive.correct(checks)
    assert checks["mismatched_files"]["value"] == \
        checks["files_checked"]["value"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_are_not_correct(tiny_base, fault):
    cell = "tiny_camera.batch"
    _, checks = _run(tiny_base, cell, entries=_broken(tiny_base, cell, fault))
    assert not drive.correct(checks)
    which = "failed_files" if fault == "half" else "mismatched_files"
    assert checks[which]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4_100_000_001, 4_100_000_002,
                                  4_100_000_003])
@pytest.mark.parametrize("cell", ["camera_1080p.batch",
                                  "camera_1080p.serial"])
def test_control_on_card(card, cell, seed):
    spec = Spec()
    rec, checks = drive.run_cell(spec, cell, seed, spec.data["run_seconds"],
                                 False, device=card, settings=CONTROL)
    print(f"control {cell} seed {seed}: {checks}")
    assert not drive.correct(checks)
    assert checks["mismatched_files"]["value"] == \
        checks["files_checked"]["value"] >= 1
