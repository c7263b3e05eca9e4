"""Ranks of a torch.distributed group: devices, the backend rule, grids of
ranks with their sub-groups, the neighbour-hop scan, and n ranks of one
function on this machine.

A JAX process owns several devices and one global Mesh spans them; a
torch.distributed process is one rank with one device.  So the JAX
package's ("host", "dp") and ("gop", "dp") meshes become a grid of ranks
with a process group for each row and each column (rank_grid), psum becomes
all_reduce, all_gather stays, and ppermute becomes isend/irecv between
ranks of a sub-group (group_excl_scan).

Backend rule (pick_backend): nccl when every rank owns a card of its own;
gloo, with the collectives' small operands on the CPU, when ranks share a
card (NCCL refuses two ranks on one device) or when the CPU is asked for.
A rank's entropy work runs on its card through the CUDA kernels in both
cases: rank r uses cuda:{r % torch.cuda.device_count()}.

run_ranks starts n ranks of one function on this machine (spawned
processes, a file:// rendezvous), which is how graft_entry.dryrun_multichip,
the tests and chip_smoke.py get their process groups without a cluster.
"""

import concurrent.futures
import contextlib
import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from .multihost import init_distributed, shutdown_distributed

TIMEOUT_S = 300  # of a collective, and of the rendezvous


def rank_device(device=None, rank=None):
    """The device of a rank: None or "cuda" -> cuda:{rank % device_count}
    (raises without a card), anything else as given.  rank defaults to this
    process's rank in the default group."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _ranks_share_a_card(num_processes, dev):
    """Whether two of num_processes ranks on `dev` land on one card: they
    do on one named card, and where there are fewer cards than ranks."""
    if dev.type != "cuda" or num_processes == 1:
        return False
    return dev.index is not None or num_processes > torch.cuda.device_count()


def pick_backend(num_processes, device=None):
    """The backend rule: "nccl" when the ranks run on cards and every rank
    owns one; "gloo" when ranks share a card or when device is the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and not _ranks_share_a_card(num_processes, dev):
        return "nccl"
    return "gloo"


def collective_device(group=None, device=None):
    """Where a collective's operands live: the rank's card under nccl
    (`device`, or the current CUDA device), the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return device or torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def compute_mode(index=0):
    """nvidia-smi's compute mode of a card ("Default", "Exclusive_Process",
    ...): in exclusive mode a second process cannot open the card."""
    res = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=compute_mode",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def check_ranks_fit(num_processes, device=None):
    """Raises where num_processes ranks cannot run on `device`: ranks that
    share a card need a compute mode that lets several processes open it.
    Returns the mode (None on the CPU or with a card a rank)."""
    dev = resolve_device(device)
    if not _ranks_share_a_card(num_processes, dev):
        return None
    mode = compute_mode(dev.index or 0)
    if mode.startswith("Exclusive"):
        raise RuntimeError(
            f"{num_processes} ranks must share {torch.cuda.device_count()} "
            f"card(s), but the compute mode is {mode}: a second process "
            f"cannot open the card"
        )
    return mode


@dataclass
class RankGrid:
    """A 2-D grid of ranks with this rank's two process groups."""

    ranks: np.ndarray  # [rows, cols] global ranks, row-major
    axis_names: tuple
    row: int  # this rank's place
    col: int
    row_group: object  # the ranks of this rank's row (it varies the column)
    col_group: object  # the ranks of this rank's column

    def group(self, axis):
        """The group this rank shares along a named axis, with its ranks in
        order and this rank's index among them."""
        if axis == self.axis_names[1]:
            return self.row_group, list(self.ranks[self.row]), self.col
        if axis == self.axis_names[0]:
            return self.col_group, list(self.ranks[:, self.col]), self.row
        raise ValueError(f"no axis {axis!r} in {self.axis_names}")


def rank_grid(rows, cols, axis_names):
    """Arrange the default group's rows * cols ranks row-major and make a
    process group for every row and every column (every rank makes all of
    them, in the same order, as new_group demands)."""
    world = dist.get_world_size()
    if rows * cols != world:
        raise ValueError(f"a {rows} x {cols} grid does not hold {world} ranks")
    ranks = np.arange(world).reshape(rows, cols)
    me = dist.get_rank()
    row, col = divmod(me, cols)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    row_groups = [dist.new_group([int(r) for r in ranks[i]], timeout=timeout)
                  for i in range(rows)]
    col_groups = [dist.new_group([int(r) for r in ranks[:, j]], timeout=timeout)
                  for j in range(cols)]
    return RankGrid(ranks, tuple(axis_names), row, col, row_groups[row],
                    col_groups[col])


def group_excl_scan(x, group, ranks, index):
    """Exclusive prefix sum of one int over the ranks of a group, by
    neighbour hops (Hillis-Steele: log2(size) doubling rounds in which
    rank i sends its partial sum to rank i + d, then one shift by one
    place); the counterpart of the JAX package's ppermute scan.  ranks:
    the group's global ranks in order; index: this rank's place among
    them.  Returns a Python int."""
    dev = collective_device(group)
    size = len(ranks)

    def hop(value, d):
        """Send `value` d places up, receive from d places down (0 where
        no rank is there)."""
        recv = torch.zeros(1, dtype=torch.int64, device=dev)
        ops = []
        if index + d < size:
            send = torch.tensor([value], dtype=torch.int64, device=dev)
            ops.append(dist.P2POp(dist.isend, send, int(ranks[index + d]),
                                  group))
        if index - d >= 0:
            ops.append(dist.P2POp(dist.irecv, recv, int(ranks[index - d]),
                                  group))
        for req in dist.batch_isend_irecv(ops) if ops else []:
            req.wait()
        return int(recv)

    incl = int(x)
    d = 1
    while d < size:
        incl += hop(incl, d)
        d *= 2
    return hop(incl, 1)


# ---------------------------------------------------------------------------
# n ranks of one function on this machine


def _rank_main(fn, rank, world, device, workdir, started, args):
    """Body of one spawned rank: output to its log file, join the group,
    run fn(rank, world, device, *args), leave the result as a pickle.
    started: the parent's time.time() when it began to start the ranks."""
    log = os.open(os.path.join(workdir, f"rank{rank}.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log, 1)
    os.dup2(log, 2)
    try:
        backend = init_distributed(
            f"file://{os.path.join(workdir, 'rendezvous')}", world, rank,
            device=device)
        start_s = time.time() - started
        result = fn(rank, world, device, *args)
        shutdown_distributed()
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump({"result": result, "backend": backend,
                         "start_s": start_s}, f)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # no cleanup that could wait for the other ranks


def run_ranks(fn, world, args=(), device=None, timeout=600):
    """Run fn(rank, world, device, *args) in `world` spawned processes that
    form one default process group (backend by pick_backend), and return
    each rank's {"result", "backend", "start_s", "exit_s"} in rank order
    (start_s: from the first process start until the rank had joined the
    group; exit_s: until its process had ended).
    fn must be importable by name (a module-level function).

    The kernels and the host library are built here first, so the ranks do
    not each compile them.  The first rank that fails makes the call raise
    a RuntimeError with that rank's output; the other ranks are killed, not
    waited for.  The same happens when `timeout` seconds pass."""
    import torch.multiprocessing as mp

    from ..host import native
    from ..ops import _build

    dev = resolve_device(device)
    check_ranks_fit(world, dev)
    native.build()
    if dev.type == "cuda":
        _build.build()
    ctx = mp.get_context("spawn")  # never fork a process that touched CUDA
    with tempfile.TemporaryDirectory(prefix="avt_ranks_") as workdir:
        t0, started = time.perf_counter(), time.time()
        procs = [
            ctx.Process(target=_rank_main,
                        args=(fn, r, world, str(dev) if device else None,
                              workdir, started, tuple(args)))
            for r in range(world)
        ]
        exit_s = [None] * world
        failed = None
        try:
            # a start returns when its child has read its arguments, which
            # is after the child imported torch: start them side by side
            with concurrent.futures.ThreadPoolExecutor(world) as pool:
                list(pool.map(lambda p: p.start(), procs))
            deadline = time.monotonic() + timeout
            while failed is None:
                codes = [p.exitcode for p in procs]
                for r, c in enumerate(codes):
                    if c is not None and exit_s[r] is None:
                        exit_s[r] = time.perf_counter() - t0
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} failed (exit code {codes[bad[0]]})", bad[0]
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > deadline:
                    alive = [r for r, c in enumerate(codes) if c is None]
                    failed = (f"ranks {alive} did not finish within "
                              f"{timeout} s"), alive[0]
                else:
                    time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(30)
        if failed is not None:
            what, r = failed
            with contextlib.suppress(OSError), \
                    open(os.path.join(workdir, f"rank{r}.log"),
                         errors="replace") as f:
                what += ":\n" + f.read()[-4000:]
            raise RuntimeError(what)
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append({**pickle.load(f), "exit_s": exit_s[r]})
        return out
