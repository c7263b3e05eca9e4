"""Host-side pieces of the CUDA kernels, held to their definitions over
their whole domains (exact, integer): the fast-counter stretch table, the
ranges the est kernel's packed state relies on, and its launch plan."""

import numpy as np
import pytest

from avrecode_tpu.models.h264_model import _apm_row
from avrecode_tpu.ops._mix_tables import SQUASH, STRETCH12
from avrecode_tpu_torch.ops import est_coder as tec
from avrecode_tpu_torch.ops import estimator as port_est
from chip_smoke import EST_ROWS_SHARED_NS


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
    traces, rows_shared, smem = tec.est_launch_plan(NS)
    per_trace = tec.TRACE_FIXED_BYTES + (tec.rows_bytes(NS) if rows_shared
                                         else 0)
    assert 1 <= traces <= tec.MAX_TRACES
    assert smem == tec.TABLE_BYTES + traces * per_trace <= tec.SMEM_BLOCK_MAX
    assert smem % 16 == 0 and tec.rows_bytes(NS) >= NS * 8
    one_trace = tec.TABLE_BYTES + tec.TRACE_FIXED_BYTES + tec.rows_bytes(NS)
    assert rows_shared == (one_trace <= tec.SMEM_BLOCK_MAX)
    # no other trace count puts more traces on an SM
    on_sm = tec.SMEM_SM // (smem + tec.SMEM_BLOCK_RESERVED) * traces
    for w in range(1, tec.MAX_TRACES + 1):
        other = tec.TABLE_BYTES + w * per_trace
        if other <= tec.SMEM_BLOCK_MAX:
            assert tec.SMEM_SM // (other + tec.SMEM_BLOCK_RESERVED) * w <= on_sm


def test_est_launch_plan_takes_both_routes():
    assert tec.est_launch_plan(2108)[1] is True
    assert tec.est_launch_plan(4096)[1] is True
    assert tec.est_launch_plan(30000)[1] is False
    assert tec.TRACE_FIXED_BYTES == 34480 and tec.TABLE_BYTES == 18432
    # the card tests' cases on the two sides of the rows' budget
    assert tec.est_launch_plan(EST_ROWS_SHARED_NS)[1] is True
    assert tec.est_launch_plan(EST_ROWS_SHARED_NS + 1)[1] is False


# the slice scope's NS, the archive cell's ~9,900 slots (rows in shared
# memory, one trace a block) and a slot table only global scratch holds
@pytest.mark.parametrize("NS, rows_shared", [
    (64, True), (2108, True), (9900, True), (30000, False)])
def test_est_stage_warps_and_rings_fit_a_block(NS, rows_shared):
    traces, shared, smem = tec.est_launch_plan(NS)
    assert shared is rows_shared
    assert smem <= tec.SMEM_BLOCK_MAX
    # a trace's stage warps, and 64 registers a thread at most: the
    # kernel's launch bounds are MAX_TRACES traces' warps
    assert traces * tec.STAGE_WARPS * 32 <= tec.MAX_TRACES * \
        tec.STAGE_WARPS * 32 == 1024
    # the rings: rows -> mixer 32 B a bin, mixer -> APM and APM -> coder
    # 4 B, the tiles' counts and two mbarriers a tile, under 6 KB a trace
    rings = tec.TRACE_FIXED_BYTES - 32 * 16 - tec.N_CLS * 8 * 4 - \
        -(-tec.N_CLS * tec.APM_HIST * tec.APM_CELLS * 2 // 16) * 16
    assert rings == tec.RING_TILES * (32 * 40 + 3 * 4 + 3 * 2 * 8) < 6 * 1024
    if NS == 9900:
        assert traces == 1


def test_est_launch_plan_keeps_traces_an_sm_at_slice_scope():
    """At the slice scope's NS = 2,108 an SM holds four traces, as it did
    with one warp a trace (two blocks of two, 110,400 B each)."""
    traces, _, smem = tec.est_launch_plan(2108)
    assert tec.SMEM_SM // (smem + tec.SMEM_BLOCK_RESERVED) * traces >= 4


class _Trace:
    """A Python-extracted trace's fields, as trace_records and slot_tables
    read them."""

    def __init__(self, rng, n, ns):
        self.slots = rng.integers(0, ns, n)
        self.bits = rng.integers(0, 2, n)
        self.pcabs = rng.integers(0, 1 << 16, n)
        self.limits = rng.integers(0x10, 0x100, ns).astype(np.int32)
        self.cls = rng.integers(0, tec.N_CLS, ns).astype(np.int32)

    def __len__(self):
        return len(self.slots)


def test_est_stage_traces_reads_zero_on_the_cpu():
    """est_stage_traces (the traces the stage-warp kernel coded) is one of
    spans.KEYS, and the CPU route, which runs the plain loop, counts none
    of its traces there; the streams are the plain version's."""
    from avrecode_tpu_torch import spans

    assert "est_stage_traces" in spans.KEYS
    rng = np.random.default_rng(25)
    traces = [_Trace(rng, n, 40) for n in (70, 33, 1)]
    stats = {}
    with spans.call("est", stats):
        streams = tec.encode_traces_est(traces, "cpu")
    assert stats["est_traces"] == 3 and stats["est_launches"] == 1
    assert stats["est_stage_traces"] == 0
    S, T, NS = 3, 70, 40
    prob = tec.from_numpy_traces(*tec.pack_rows(traces, S, T, NS), "cpu")
    assert streams == tec.finalize_streams(*tec.est_encode_plain(*prob))


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
