"""Entry points of the port: the single-device step and the multi-rank
dry run.

entry(device=None) -> (fn, example_args): the flagship device step, the
lane-parallel estimator-free entropy coder (ops/lane_coder.py): bare range
coding of (bit, p1) sub-streams by lane_encode, then the on-device
finalize.  Counterpart of the JAX package's entry(), on the same fixed
(8, 256) problem from RandomState(0); the arguments are the port's compact
lane problem (uint16 p1, int32 bit words, int32 lens) on `device`.

dryrun_multichip(n, device=None): starts n ranks of one torch.distributed
group on this machine, arranged as a ("gop", "dp") grid, and runs the REAL
compression step on them: lanes of a real clip's slice traces, one
contiguous shard a rank, coded by lane_encode on the rank's device; the
cross-rank billing all_reduce; and every shard's container byte offset
computed BOTH ways, a hierarchical neighbour-hop prefix scan (within the
dp group, then across the gop group) and an all_gather + masked sum,
asserted equal.  Rank 0 asserts that the sharded result is byte-identical
to the single-device path.  Counterpart of the JAX package's
dryrun_multichip on its ("gop", "dp") mesh.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .ops.lane_coder import (
    finalize_device,
    finalize_lanes,
    from_numpy_problem,
    lane_encode,
    pack_compact,
    split_lanes,
)
from .parallel import ranks
from .parallel.pipeline import extract_traces

DRYRUN_CLIP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "data", "rt_ctr.mkv")
DRYRUN_B = 512


def entry(device=None):
    dev = resolve_device(device)
    B = 256

    def step(p1u16, bitw, lens):
        return finalize_device(*lane_encode(p1u16, bitw, lens), B // 4 + 8)

    rng = np.random.RandomState(0)
    p1 = rng.randint(1, 0xFFFF, (8, B)).astype(np.int32)
    bit = rng.randint(0, 2, (8, B)).astype(np.int32)
    lens = np.full(8, B, np.int32)
    problem = pack_compact(p1 | (bit << 16), lens, pad_lanes=1)
    return step, from_numpy_problem(*problem, dev)


def _real_lane_problem(B):
    """The compact lane problem (p1u16, bitw, lens) of the pinned clip's
    slice traces; a missing clip raises."""
    with open(DRYRUN_CLIP, "rb") as f:
        data = f.read()
    traces = extract_traces(data, scope="slice")[3]
    if not traces:
        raise RuntimeError(f"{DRYRUN_CLIP} gave no slice traces")
    bitp1, lens, _ = split_lanes(traces, B)
    return pack_compact(bitp1, lens, pad_lanes=1)


def _dryrun_rank(rank, world, device, p1u16, bitw, lens, L, fail_rank):
    """One rank of dryrun_multichip (run under ranks.run_ranks); the
    arrays are the whole problem, padded to a multiple of `world` rows."""
    dev = ranks.rank_device(device, rank)
    gop = 2 if world % 2 == 0 and world > 1 else 1
    dp = world // gop
    grid = ranks.rank_grid(gop, dp, ("gop", "dp"))
    cdev = ranks.collective_device(None, dev)

    def as_int(t):
        return int(t.cpu())

    def reduce_sum(x, group=None):
        t = torch.tensor([x], dtype=torch.int64, device=cdev)
        dist.all_reduce(t, group=group)
        return as_int(t)

    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} was asked to fail")
    per = p1u16.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    before = lane_encode.launches
    t0 = time.perf_counter()
    prob = from_numpy_problem(p1u16[rows], bitw[rows], lens[rows], dev)
    tok, car, ftok, fcar = lane_encode(*prob)
    # per-shard emitted-byte count -> the billing ledger (all_reduce) and the
    # shard's byte offset in the assembled container.  The offset is an
    # exclusive prefix over the ranks, computed TWICE: a hierarchical
    # neighbour-hop scan (within the dp group, then across the gop group)
    # and an all_gather + masked sum; both must agree.
    shard_bytes = as_int(((tok >> 16) & 3).sum()) + 2 * per
    work_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    total = reduce_sum(shard_bytes)
    dp_excl = ranks.group_excl_scan(shard_bytes, *grid.group("dp"))
    row_total = reduce_sum(shard_bytes, grid.row_group)
    gop_excl = ranks.group_excl_scan(row_total, *grid.group("gop"))
    offset_pp = gop_excl + dp_excl
    mine = torch.tensor([shard_bytes], dtype=torch.int64, device=cdev)
    allb = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(allb, mine)
    offset = sum(as_int(b) for r, b in enumerate(allb) if r < rank)

    # rank 0 holds every rank's tokens, offsets and totals to the host's
    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return [p.cpu().numpy() for p in parts]

    toks = gather(torch.cat([tok.reshape(-1), car.reshape(-1), ftok,
                             fcar]).to(cdev))
    sums = np.array(gather(torch.tensor([offset, offset_pp, total],
                                        dtype=torch.int64, device=cdev)))
    collectives_s = time.perf_counter() - t0
    launches = lane_encode.launches - before
    if rank == 0:
        n = per * p1u16.shape[1]
        tok_g, car_g = (
            np.concatenate([p[lo: lo + n].reshape(per, -1) for p in toks])
            for lo in (0, n))
        ftok_g, fcar_g = (
            np.concatenate([p[lo: lo + per] for p in toks])
            for lo in (2 * n, 2 * n + per))
        offsets, offsets_pp, totals = sums.T

        # the sharded step must be byte-identical to the single-device path
        streams = finalize_lanes(tok_g[:L], car_g[:L], ftok_g[:L], fcar_g[:L],
                                 lens[:L])
        whole = lane_encode(*from_numpy_problem(p1u16, bitw, lens, dev))
        ref = finalize_lanes(*(t.cpu().numpy() for t in whole), lens)[:L]
        assert streams == ref, "sharded lane encode diverged from single-device"

        # collective outputs must reconcile with a host-side recount
        per_shard = ((tok_g >> 16) & 3).reshape(world, -1).sum(axis=1) + 2 * per
        assert (totals == int(per_shard.sum())).all(), (totals, per_shard)
        np.testing.assert_array_equal(
            offsets, np.concatenate([[0], np.cumsum(per_shard)[:-1]]))
        # the neighbour-hop hierarchical scan must agree with the all_gather
        np.testing.assert_array_equal(offsets_pp, offsets)
    return {"device": str(dev), "launches": launches, "lanes": L,
            "grid": (gop, dp), "total": total, "offset": offset,
            "work_s": work_s, "collectives_s": collectives_s}


def dryrun_multichip(n_devices, device=None, timeout=600, _fail_rank=None):
    """Run the dry run over n_devices ranks (see the module docstring).
    device=None puts rank r on cuda:{r % device_count} and raises without a
    card; "cpu" runs the ranks on the CPU over gloo, with the kernels'
    plain versions.  Raises if a rank fails (with that rank's output) or
    `timeout` seconds pass.  Returns every rank's report, in rank order:
    run_ranks' entries, whose "result" holds the rank's device, its
    lane_encode launches, the billing total, its offset and its times.
    (_fail_rank makes that rank raise, for the tests of the failure
    path.)"""
    resolve_device(device)
    p1u16, bitw, lens = _real_lane_problem(DRYRUN_B)
    L = p1u16.shape[0]
    Lp = -(-L // n_devices) * n_devices
    p1u16 = np.pad(p1u16, ((0, Lp - L), (0, 0)))
    bitw = np.pad(bitw, ((0, Lp - L), (0, 0)))
    lens = np.pad(lens, (0, Lp - L))
    return ranks.run_ranks(
        _dryrun_rank, n_devices, (p1u16, bitw, lens, L, _fail_rank),
        device=device, timeout=timeout)
