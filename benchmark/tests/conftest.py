"""Fixtures of the benchmark's own tests (python -m pytest benchmark/tests
from the repository root; the repository's tier-1 run does not collect
them).  Tests that need the card carry the `cuda` marker and take the
`card` fixture, which decides inside the test whether one is present."""

import json
import pathlib
import shutil
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
DATA = pathlib.Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# data/gopN.264: tools/genvideo gopN.264 192 160 8 30 8 2 26 SEED 1
# repeat-headers=1, SEED 903, 905, 907: one closed GOP each, SPS and PPS first
TINY_GOPS = ["gop1.264", "gop2.264", "gop3.264"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def make_base(tmp_path, cells, configs):
    """A benchmark directory of its own under tmp_path: the repository's
    traffic mixes and metric readers, the given configurations (with their
    pools copied in) and a BENCHMARK.json of the given cells and the
    repository's metrics."""
    base = tmp_path / "bench"
    shutil.copytree(BENCH / "traffic", base / "traffic")
    shutil.copytree(BENCH / "metrics", base / "metrics")
    (base / "configs").mkdir()
    for name, (src_dir, files, job, warm) in configs.items():
        pool = base / "clips" / name
        pool.mkdir(parents=True)
        for f in files:
            shutil.copy(src_dir / f, pool / f)
        config = {"name": name, "source": "test",
                  "settings": {"scope": "gop", "substream_bins": 16384},
                  "pool": {"dir": f"clips/{name}", "files": files},
                  "job": job, "warm_files": warm, "reduced": [],
                  "assumed": []}
        (base / "configs" / f"{name}.json").write_text(json.dumps(config))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": c, "config": c.split(".")[0], "traffic": c.split(".")[1],
         "chips": 1, "why": "test"} for c in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


@pytest.fixture
def tiny_base(tmp_path):
    """Both mixes over a tiny configuration: recordings of the three small
    test GOPs, jobs of two."""
    return make_base(
        tmp_path, ["tiny_camera.batch", "tiny_camera.serial"],
        {"tiny_camera": (DATA, TINY_GOPS,
                         {"kind": "recordings", "recording_gops": [[3, 6]]},
                         1)})


def spec_of(base):
    from benchmark.harness.spec import Spec
    return Spec(base / "BENCHMARK.json", base)
