"""The est stage's record form on the CPU: every group goes to the device
as its traces' 8-byte records (the native extractor's, viewed as they
are; the Python extractor's traces packed into the same layout) and is
unpacked there into the est kernel's rows (est_coder.est_unpack, whose CPU
route is est_unpack_plain); nothing packs rows on the host.

The unpack must give pack_rows' rows bit for bit; encode_traces_est must
give the host model coder's streams on either extractor's traces, without
pack_rows, and leave NativeTrace's cached slots, bits and pcabs unfilled.
Groups are cut by a padded-bins budget (cut_groups), on a card half its
free memory over the bytes a padded bin costs (card_group_bins), read as
each group is cut.
The plain est loop steps through each group's longest trace: traces stay
a few hundred to 1,500 bins, ~10 s in all."""

import functools
import os
import random

import numpy as np
import pytest
import torch

from avrecode_tpu.models.h264_model import RecodeModel
from avrecode_tpu_torch import spans
from avrecode_tpu_torch.host import native
from avrecode_tpu_torch.models.trace import CLS_IDS, TraceModel
from avrecode_tpu_torch.ops import est_coder as tec

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CLS_NAMES = {i: n for n, i in CLS_IDS.items()}


def _records(slots, bits, pcabs, p1s):
    """u64 records in NativeTrace's layout: lo32 = slot | bit << 24, hi32 =
    pcab | p1 << 16."""
    u = np.uint64
    return (np.asarray(slots, u) | np.asarray(bits, u) << u(24)
            | np.asarray(pcabs, u) << u(32) | np.asarray(p1s, u) << u(48))


def _synthetic(lens, NS, seed, edges=False):
    """NativeTraces of the given lengths over NS slots from a seed; with
    edges, the first bins of each take slot NS - 1, pcab 0xFFFF, bit 1 and
    p1 0xFFFF (every p1 bit set)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        slots = rng.integers(0, NS, n)
        bits = rng.integers(0, 2, n)
        pcabs = rng.integers(0, 1 << 16, n)
        p1s = rng.integers(1, 1 << 16, n)
        if edges:
            k = min(n, 3)
            slots[:k], bits[:k], pcabs[:k], p1s[:k] = NS - 1, 1, 0xFFFF, 0xFFFF
        limits = rng.integers(0x10, 0x100, NS).astype(np.int32)
        cls = rng.integers(0, len(CLS_IDS), NS).astype(np.int32)
        out.append(native.NativeTrace(_records(slots, bits, pcabs, p1s),
                                      limits, cls))
    return out


def _real(lens):
    """Prefixes of rt_ctr.mkv's slice traces (records, slot tables and
    classes of the native extractor) of the given lengths."""
    if not native.available():
        pytest.skip("native library not built")
    with open(os.path.join(DATA, "rt_ctr.mkv"), "rb") as f:
        full = native.extract(f.read(), "slice", want_slots=True)[3]
    return [native.NativeTrace(t.recs[:n], t.limits, t.cls, t._handle)
            for t, n in zip(full, lens)]


# (traces, S): ragged traces; an empty one; one bin; a slot at NS - 1 with
# pcab 0xFFFF, bit 1 and every p1 bit set; rows past the traces (padding)
UNPACK_CASES = {
    "ragged": (lambda: _synthetic((37, 5, 100, 64), 50, 1), 4),
    "empty": (lambda: _synthetic((0, 20, 0), 9, 2), 3),
    "one_bin": (lambda: _synthetic((1,), 1, 3), 1),
    "edges": (lambda: _synthetic((3, 40, 1), 12, 4, edges=True), 3),
    "padding_rows": (lambda: _synthetic((7, 0, 30), 16, 5), 6),
    "real": (lambda: _real((13796, 4649, 1, 0)), 5),
}


@pytest.mark.parametrize("case", sorted(UNPACK_CASES))
def test_unpack_equals_pack_rows(case):
    make, S = UNPACK_CASES[case]
    traces = make()
    T = max(max(len(t) for t in traces), 1)
    NS = max(max(len(t.limits) for t in traces), 1)
    recs = [torch.from_numpy(tec.trace_records(t)) for t in traces]
    slots, bits, pcabs, _, valid, _ = tec.pack_rows(traces, S, T, NS)
    for got in (tec.est_unpack(recs, S, T), tec.est_unpack_plain(recs, S, T)):
        for g, w in zip(got, (slots, bits, pcabs, valid)):
            assert g.dtype == torch.int32 and g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), w)


def test_unpack_checks_its_inputs():
    r = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="1 to S"):
        tec.est_unpack([], 2, 4)
    with pytest.raises(ValueError, match="1 to S"):
        tec.est_unpack([r, r, r], 2, 4)
    with pytest.raises(ValueError, match="longer than T"):
        tec.est_unpack([r], 1, 3)
    with pytest.raises(TypeError, match="int64"):
        tec.est_unpack([r.to(torch.int32)], 1, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tec.est_unpack([torch.zeros(8, dtype=torch.int64)[::2]], 1, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tec.est_unpack([r.to("meta")], 1, 4)


def test_trace_records_only_where_the_records_hold_slots():
    t = _synthetic((5,), 4, 6)[0]
    view = tec.trace_records(t)
    assert view.dtype == np.int64 and np.shares_memory(view, t.recs)
    # extracted with want_slots=False: no slot table, slots not remapped
    with pytest.raises(ValueError, match="want_slots=False"):
        tec.trace_records(native.NativeTrace(t.recs, t.limits[:0]))
    assert len(tec.trace_records(native.NativeTrace(t.recs[:0],
                                                    t.limits[:0]))) == 0
    assert tec.trace_records(TraceModel()).dtype == np.int64


def test_python_traces_pack_into_the_record_layout():
    t = _python_traces((200,), 11)[0]
    r = tec.trace_records(t)
    assert r.dtype == np.int64 and len(r) == len(t)
    np.testing.assert_array_equal(r & 0xFFFFFF, t.slots)
    np.testing.assert_array_equal((r >> 24) & 0xFF, t.bits)
    np.testing.assert_array_equal((r >> 32) & 0xFFFF, t.pcabs)
    assert not (r >> 48).any()  # no p1: the est stage does not read it
    for field, value in (("slots", 1 << 24), ("bits", 2), ("pcabs", 1 << 16),
                         ("pcabs", -1)):
        bad = _python_traces((3,), 12)[0]
        getattr(bad, field)[1] = value
        with pytest.raises(ValueError, match="out of range"):
            tec.trace_records(bad)


def _python_traces(lens, seed):
    """TraceModels (the Python extractor's traces: no records) of the given
    lengths, over random keys."""
    rnd = random.Random(seed)
    keys = [("ctx", i) for i in range(30)] + [("sig", 2, i, 0, 1)
                                              for i in range(10)]
    out = []
    for n in lens:
        t = TraceModel()
        for _ in range(n):
            t.put_bit(rnd.choice(keys), rnd.randint(0, 1),
                      rnd.choice([None, rnd.randint(1, 0xFFFF)]))
        out.append(t)
    return out


def _host_stream(t):
    """A trace through the host model coder, each slot keyed by its class
    (which sets its halving limit) and its id."""
    if isinstance(t, native.NativeTrace):
        r = t.recs
        cols = (r & 0xFFFFFF, (r >> 24) & 1, (r >> 32) & 0xFFFF)
    else:
        cols = (t.slots, t.bits, t.pcabs)
    m = RecodeModel("encode")
    for s, b, p in zip(*(np.asarray(c).tolist() for c in cols)):
        m.put_bit((CLS_NAMES[int(t.cls[s])], s), b, p or None)
    return m.finish()


# traces by extractor, GROUP_BINS 2,000 cutting them into several groups
FORMS = {
    "native": lambda: _real((1500, 0, 600, 1, 900, 300)),
    "python": lambda: _python_traces((1500, 0, 600, 1, 900, 300), 7),
    "mixed": lambda: (_real((1500, 1, 300))
                      + _python_traces((600, 0, 900), 8)),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_groups_of_either_form_give_the_host_streams(form, monkeypatch):
    traces = FORMS[form]()
    monkeypatch.setattr(tec, "GROUP_BINS", 2000)

    def no_host_rows(*_):
        raise AssertionError("the est stage packed rows on the host")

    monkeypatch.setattr(tec, "pack_rows", no_host_rows)
    stats = {}
    with spans.call("est", stats):
        streams = tec.encode_traces_est(traces, device="cpu")
    assert streams == [_host_stream(t) for t in traces]
    assert stats["est_launches"] >= 3 and stats["est_traces"] == len(traces)
    assert stats["est_memory_cuts"] == 0  # GROUP_BINS cut them, no card
    assert stats["est_wait_s"] == 0  # the CPU route waits for no kernel
    # the records as they are: no native trace's fields cached
    assert all(t._slots is None and t._bits is None and t._pcabs is None
               for t in traces if isinstance(t, native.NativeTrace))


GOP_BINS = 7_410_000  # a GOP-long trace of the archive cell
# (lengths, padded-bins budget, groups of trace indices)
CUTS = {
    "one_group": ([GOP_BINS] * 48, 48 * GOP_BINS, [list(range(48))]),
    "fixed_2_27": ([GOP_BINS] * 48, 1 << 27,
                   [list(range(18)), list(range(18, 36)),
                    list(range(36, 48))]),
    "a_trace_each": ([5, 0, 3, 3], 1, [[1], [2], [3], [0]]),
    "shortest_first": ([900, 1, 300, 300, 50], 700, [[1, 4], [2, 3], [0]]),
}


@pytest.mark.parametrize("case", sorted(CUTS))
def test_groups_are_cut_by_a_padded_bins_budget(case):
    lengths, budget, groups = CUTS[case]
    assert list(tec.cut_groups(lengths, lambda: budget)) == groups


def _fill_card(monkeypatch, lengths, size, once):
    """Groups cut from a fake card of `size` bytes that fills as they are
    launched: each launched group holds its tok and car, 16 B a padded
    bin, until the collect, and the card's free memory is what they leave.
    The budget is card_group_bins, read as each group is cut or, if
    `once`, once before the first.  -> (groups, each group's peak: what
    the groups before hold and EST_BIN_BYTES a padded bin of its own)."""
    held = [0]
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (size - held[0], size))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 0)
    read = functools.partial(tec.card_group_bins, torch.device("cuda", 0))
    if once:
        first = read()
        read = lambda: first  # noqa: E731
    groups, peaks = [], []
    for grp in tec.cut_groups(lengths, read):
        bins = len(grp) * max(lengths[i] for i in grp)
        peaks.append(held[0] + tec.EST_BIN_BYTES * bins)
        held[0] += 16 * bins
        groups.append(grp)
    return groups, peaks


def test_card_budget_leaves_out_the_groups_launched_before(monkeypatch):
    """100 GOP-long traces on a card of 40 traces' EST_BIN_BYTES: the
    budget, read as each group is cut, shrinks as the launched groups'
    results fill the card, and no group's peak passes the card; read once
    for the shard it cuts groups of 20, and the fourth passes it."""
    size = 40 * GOP_BINS * tec.EST_BIN_BYTES
    lengths = [GOP_BINS] * 100
    groups, peaks = _fill_card(monkeypatch, lengths, size, once=False)
    assert len(groups) >= 5 and max(peaks) <= size
    assert [len(g) for g in groups[:3]] == [20, 16, 13]
    assert [i for g in groups for i in g] == list(range(100))
    groups, peaks = _fill_card(monkeypatch, lengths, size, once=True)
    assert {len(g) for g in groups} == {20} and peaks[3] > size


def test_card_budget_is_half_the_free_memory_over_a_bins_bytes(monkeypatch):
    """Free bytes are the driver's free memory and the caching allocator's
    reserved but unallocated bytes; half of them over EST_BIN_BYTES, the
    sum of the stage's per-bin allocations."""
    dev = torch.device("cuda", 3)
    seen = []

    def mem_get_info(d):
        seen.append(d)
        return 30 << 30, 80 << 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 6 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 2 << 30)
    assert tec.EST_BIN_BYTES == 8 + 16 + 16 + 4
    assert tec.card_group_bins(dev) == (34 << 30) // 2 // 44
    assert seen == [dev]
    # 34 GiB free holds a 48-GOP recording of the archive cell at once
    assert tec.card_group_bins(dev) >= 48 * GOP_BINS


def test_a_slot_past_the_table_still_raises():
    t = _synthetic((10,), 4, 9)[0]
    bad = t.recs.copy()
    bad[3] = (bad[3] & ~np.uint64(0xFFFFFF)) | np.uint64(4)  # slot NS
    with pytest.raises(ValueError, match="out of range"):
        tec.encode_traces_est([native.NativeTrace(bad, t.limits, t.cls)],
                              device="cpu")
