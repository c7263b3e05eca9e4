"""Host-side pieces of the CUDA kernels, held to their definitions over
their whole domains (exact, integer): the fast-counter stretch table, the
ranges the est kernel's packed state relies on, and its launch plan."""

import numpy as np
import pytest

from avrecode_tpu.models.h264_model import _apm_row
from avrecode_tpu.ops._mix_tables import SQUASH, STRETCH12
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import estimator as port_est


def _counter_step(c0, c1, bit, limit):
    """The model's counter update (estimator.model_probs)."""
    c0, c1 = c0 + (bit == 1), c1 + (bit != 1)
    if c0 + c1 > limit:
        c0, c1 = (c0 + 1) >> 1, (c1 + 1) >> 1
    return c0, c1


def test_fast_stretch_table_matches_definition():
    tab = tec.fast_stretch_table()
    assert tab.shape == (1024,) and tab.dtype == np.int32
    for f0 in range(32):
        for f1 in range(32):
            if f0 == 0 or f1 == 0:
                assert tab[f0 | f1 << 5] == 0
                continue
            pf = min(max((f0 << 16) // (f0 + f1), 1), 0xFFFF)
            assert tab[f0 | f1 << 5] == STRETCH12[pf >> 4], (f0, f1)


def test_fast_counters_stay_inside_the_table():
    """Every (f0, f1) the model can reach from (1, 1): both counters in
    [1, 31], so the 5-bit fields and the table index hold them."""
    seen, todo = {(1, 1)}, [(1, 1)]
    while todo:
        f = todo.pop()
        for bit in (0, 1):
            g = _counter_step(*f, bit, port_est.HALVE_FAST)
            if g not in seen:
                seen.add(g)
                todo.append(g)
    assert len(seen) > 100
    assert all(1 <= f0 < 32 and 1 <= f1 < 32 for f0, f1 in seen)
    assert max(f0 + f1 for f0, f1 in seen) <= port_est.HALVE_FAST


@pytest.mark.parametrize("limit", [0, 1, 2, 3, 0x10, 0x60, 0x7FFE, 0x7FFF])
def test_slow_counters_fit_15_bits(limit):
    """Counters under any halving limit the wrapper admits stay in
    [1, 0x7FFF] after every update: all ones, all zeros, alternating and
    random bits, long enough to reach the limit twice."""
    assert limit <= tec.MAX_LIMIT == 0x7FFF
    rng = np.random.default_rng(limit)
    n = 2 * limit + 50
    for bits in (np.ones(n, int), np.zeros(n, int), np.arange(n) % 2,
                 rng.integers(0, 2, n)):
        e = (1, 1)
        for b in bits:
            e = _counter_step(*e, int(b), limit)
            assert 1 <= e[0] <= 0x7FFF and 1 <= e[1] <= 0x7FFF
            assert e[0] + e[1] <= max(limit, 2)


def test_apm_cells_fit_uint16():
    """The APM update keeps a cell inside [0, 65535] from any such cell,
    for both targets and every interpolation weight; the identity row
    starts inside."""
    row = np.asarray(_apm_row())
    assert row.min() >= 0 and row.max() <= 0xFFFF and len(row) == port_est.APM_CELLS
    a = np.arange(0x10000, dtype=np.int64)[:, None]
    w = np.arange(129, dtype=np.int64)[None, :]
    for tgt in (0, 1 << 16):
        new = a + (((tgt - a) * w) >> (7 + port_est.APM_RATE))
        assert new.min() >= 0 and new.max() <= 0xFFFF


def test_tables_fit_the_kernels_narrow_types():
    s, q = np.asarray(STRETCH12), np.asarray(SQUASH)
    assert len(s) == len(q) == 4096
    assert s.min() >= -2048 and s.max() <= 2047  # 12-bit field of a row
    assert q.min() >= 0 and q.max() <= 0xFFFF
    tbl, apm_row = port_est.est_tables("cpu")
    assert np.array_equal(tbl[:, 0].numpy(), s)
    assert np.array_equal(tbl[:, 1].numpy(), q)


@pytest.mark.parametrize("NS", [1, 2, 64, 511, 512, 1024, 2108, 3494, 4096,
                                10000, 23000, 24000, 100000, 1 << 20])
def test_est_launch_plan(NS):
    warps, rows_shared, smem = tec.est_launch_plan(NS)
    per_warp = tec.WARP_FIXED_BYTES + (tec.rows_bytes(NS) if rows_shared else 0)
    assert 1 <= warps <= tec.MAX_WARPS
    assert smem == tec.TABLE_BYTES + warps * per_warp <= tec.SMEM_BLOCK_MAX
    assert smem % 16 == 0 and tec.rows_bytes(NS) >= NS * 8
    one_warp = tec.TABLE_BYTES + tec.WARP_FIXED_BYTES + tec.rows_bytes(NS)
    assert rows_shared == (one_warp <= tec.SMEM_BLOCK_MAX)
    # no other warp count puts more traces on an SM
    on_sm = tec.SMEM_SM // (smem + tec.SMEM_BLOCK_RESERVED) * warps
    for w in range(1, tec.MAX_WARPS + 1):
        other = tec.TABLE_BYTES + w * per_warp
        if other <= tec.SMEM_BLOCK_MAX:
            assert tec.SMEM_SM // (other + tec.SMEM_BLOCK_RESERVED) * w <= on_sm


def test_est_launch_plan_takes_both_routes():
    assert tec.est_launch_plan(2108)[1] is True
    assert tec.est_launch_plan(4096)[1] is True
    assert tec.est_launch_plan(30000)[1] is False
    assert tec.WARP_FIXED_BYTES == 29120 and tec.TABLE_BYTES == 18432


_BUILD_STUB = r"""
import sys, time
from pathlib import Path
from avrecode_tpu_torch.ops import _build

_build.BUILD_DIR = Path(sys.argv[1])
calls = Path(sys.argv[1]) / "calls.txt"

def compile_stub(out):
    with open(calls, "a") as f:
        f.write("compiled\n")
    time.sleep(1.0)  # long enough for the other processes to queue up
    Path(out).write_bytes(b"library")
    class Result:
        returncode, stdout, stderr = 0, "stub log", ""
    return ["stub"], Result

_build._compile = compile_stub
so = _build.build()
assert so.read_bytes() == b"library" and so == _build.library_path()
print(so.name)
"""


def test_kernel_build_runs_once_under_concurrent_first_use(tmp_path):
    """Processes that call build() at once with nothing built (ranks, test
    workers): one compiles under the file lock, the others wait and find
    its library."""
    import os
    import subprocess
    import sys

    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD_STUB, str(tmp_path)],
                         cwd=root, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for _ in range(3)
    ]
    names = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
        names.append(out.strip())
    assert len(set(names)) == 1 and names[0].endswith(".so")
    assert (tmp_path / "calls.txt").read_text() == "compiled\n"
    assert (tmp_path / names[0]).with_suffix(".log").read_text() == "stub log"
    assert not list(tmp_path.glob("*.tmp"))


def test_kernel_build_failure_raises_with_the_compiler_output(tmp_path,
                                                              monkeypatch):
    from pathlib import Path

    from avrecode_tpu_torch.ops import _build

    class Result:
        returncode, stdout, stderr = 1, "", "error: no such kernel"

    monkeypatch.setattr(_build, "BUILD_DIR", Path(tmp_path))
    monkeypatch.setattr(_build, "_compile", lambda out: (["nvcc"], Result))
    with pytest.raises(RuntimeError, match="no such kernel"):
        _build.build()
    assert not list(Path(tmp_path).glob("*.so"))
