"""The port's compress and decompress paths on the stream classes beyond
CABAC 4:2:0 8-bit frames: I_PCM, CAVLC, 4:4:4 10-bit, PAFF field pictures,
monochrome, separate colour planes and SP/SI slices.  The clips are made as
the JAX package's tests make them (tools/gen_*.py with the framework's own
CABAC writer, tools/genvideo with x264), at small sizes and under names of
their own, so that this file runs in about a minute beside those tests.

For every class, with device="cpu" (the plain torch versions):
  * device_compress on the lane path (B = 512, slice scope) equals the JAX
    package's device_compress and the port's codec.compress;
  * device_compress on the est path (substream_bins=0) equals the JAX
    package's device_compress and the port's native.compress;
  * device_decompress gives the file back from both containers;
  * the port's host layer (native.extract, codec.compress) equals the JAX
    package's on the clip.
All byte for byte: the arithmetic is exact integers."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from avrecode_tpu import codec as jcodec
from avrecode_tpu.host import native as jnative
from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch import codec
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.parallel import pipeline as tpipe

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "data")
GEN = os.path.join(ROOT, "tools", "genvideo")
B = 512

# class -> (file name, generator script or None for genvideo, arguments)
CLASSES = {
    "pcm": ("tsc_pcm.264", "gen_pcm.py", ["4x3", "2"]),
    "cavlc": ("tsc_cavlc.mp4", None,
              ["96", "80", "6", "30", "3", "0", "26", "7", "1", "cabac=0"]),
    "444_10bit": ("tsc_444_10.mp4", None,
                  ["96", "80", "4", "30", "4", "1", "26", "3", "1", "x",
                   "44410"]),
    "paff": ("tsc_paff.264", "gen_paff.py", ["4x4", "3"]),
    "mono": ("tsc_mono.264", "gen_mono.py", ["8x6", "3"]),
    "sep": ("tsc_sep.264", "gen_sep.py", ["4x3", "4"]),
    "spsi": ("tsc_spsi.264", "gen_sp.py", ["16x12"]),
}


@functools.cache
def _clip(cls):
    """The class's clip, generated on first use (to a name of this process,
    then renamed: another test process may want the same file)."""
    name, script, args = CLASSES[cls]
    path = os.path.join(DATA, name)
    if not os.path.exists(path):
        stem, ext = os.path.splitext(path)
        tmp = f"{stem}.{os.getpid()}{ext}"
        if script is None:
            if not os.path.exists(GEN):
                pytest.skip("tools/genvideo is not built")
            env = dict(os.environ, AVT_COMB="0", AVT_NOISE="15")
            cmd = [GEN, tmp, *args]
        else:
            env = None
            cmd = [sys.executable, os.path.join(ROOT, "tools", script), tmp,
                   *args]
        subprocess.run(cmd, check=True, capture_output=True, cwd=ROOT,
                       env=env)
        os.replace(tmp, path)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip("native library not built")


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_lane_path_matches_jax_and_host(cls):
    data = _clip(cls)
    stats = tpipe.extract_traces(data, scope="slice", want_slots=False)[4]
    assert stats["native"] is True  # the class recodes: no literal fallback
    port = tpipe.device_compress(data, scope="slice", substream_bins=B,
                                 device="cpu")
    assert port == jpipe.device_compress(data, scope="slice",
                                         substream_bins=B)
    assert port == codec.compress(data, scope="slice", substream_bins=B)
    assert native.decompress(port) == data


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_est_path_matches_jax_and_host(cls):
    data = _clip(cls)
    port = tpipe.device_compress(data, scope="slice", substream_bins=0,
                                 device="cpu")
    assert port == jpipe.device_compress(data, scope="slice",
                                         substream_bins=0)
    assert port == native.compress(data, scope="slice")
    assert native.decompress(port) == data


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_device_decompress_gives_the_file_back(cls):
    data = _clip(cls)
    for blob in (codec.compress(data, scope="slice", substream_bins=B),
                 native.compress(data, scope="slice")):
        assert tpipe.device_decompress(blob, device="cpu") == data


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_host_layer_matches_original(cls):
    data = _clip(cls)
    for scope in ("slice", "gop"):
        assert (native.compress(data, scope=scope)
                == jnative.compress(data, scope=scope))
        mine = native.extract(data, scope)[3]
        theirs = jnative.extract(data, scope)[3]
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.recs32(), b.recs32())
            np.testing.assert_array_equal(a.limits, b.limits)
    assert (codec.compress(data, scope="gop", substream_bins=B)
            == jcodec.compress(data, scope="gop", substream_bins=B))
