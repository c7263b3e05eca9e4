"""The result's last line: exactly the contract's keys, the numbers
compared last; no result without a card."""

import json

import pytest

from conftest import spec_of

from benchmark import run
from benchmark.harness import drive

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(tiny_base, trace):
    spec = spec_of(tiny_base)
    cell = spec.cell("tiny_camera.batch")
    rec, checks = drive.run_cell(spec, cell["name"], 5, 0.05, trace,
                                 device="cpu")
    line = run.result_line(spec, cell, rec, checks, trace, "cpu rehearsal")
    want = CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert json.loads(json.dumps(line)) == line
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    names = {m["name"] for m in spec.metrics(cell["name"], trace)}
    if not trace:
        assert set(line["metrics"]) == names
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["correct"] is True
    assert line["attempted"] == len(rec["produced"]) and line["failed"] == 0
    for c in line["checks"].values():
        assert "value" in c and ("limit" in c or "at_least" in c)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "camera_1080p.batch", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_peak_rss_is_the_windows_own():
    import time
    import numpy as np
    from benchmark.harness import spans
    mb = 1 << 20
    before = np.ones(256 * mb, np.uint8)  # a peak before the window...
    del before
    start = spans.rss_now()
    with spans.PeakRSS() as rss:
        inside = np.ones(64 * mb, np.uint8)
        time.sleep(5 * spans.RSS_EVERY_S)
        del inside
    # ...is not the window's; the window's is kept though it was freed
    assert start + 60 * mb <= rss.peak <= start + 128 * mb
