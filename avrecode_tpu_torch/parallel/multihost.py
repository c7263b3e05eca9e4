"""Multi-process scale-out over torch.distributed: GOP ranges across
processes, one rank each.

Counterpart of avrecode_tpu/parallel/multihost.py, with the same function
names.  The decomposition is the JAX package's:

  process  <- a contiguous range of GOPs (entropy-independent under
              scope=gop, so no state is ever exchanged for correctness;
              only the fragments and the billing/metrics reduction ride
              the collectives)

What changes is the idiom: jax.distributed becomes a torch.distributed
process group, the ("host", "dp") Mesh a grid of ranks with its sub-groups,
and process_allgather an all_gather of padded tensors (parallel/ranks.py
has the rank layer and the backend rule: nccl when every rank owns a card,
gloo when ranks share one or the CPU is asked for).  (One process driving
several devices is the other shape of parallelism: parallel/mesh.py.)

The GOP sharding itself (compress_sharded, stitch, decompress_sharded,
stitch_decompressed) is host code, and the command line uses it without a
process group: torch is loaded only by the functions that talk to one.
"""

import numpy as np

from ..utils.container import KIND_END, scan_gop_groups


def init_distributed(coordinator, num_processes, process_id,
                     local_device_ids=None, device=None):
    """Join the default process group: rank process_id of num_processes,
    rendezvous at tcp://coordinator ("host:port"; a full init method such
    as file:///path is taken as given).  The backend follows
    ranks.pick_backend; under nccl the rank's card becomes the current
    device (local_device_ids[0] where given, else ranks.rank_device).
    Collectives and the rendezvous time out after ranks.TIMEOUT_S.  Returns
    the backend.

    A rank that joined must call shutdown_distributed() when its work is
    done: a process that exits with the group (and, on rank 0, the
    rendezvous store) still alive can abort in interpreter shutdown."""
    import datetime

    import torch
    import torch.distributed as dist

    from . import ranks

    backend = ranks.pick_backend(num_processes, device)
    method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend == "nccl":
        torch.cuda.set_device(
            torch.device("cuda", local_device_ids[0]) if local_device_ids
            else ranks.rank_device(device, process_id))
    dist.init_process_group(
        backend, init_method=method, world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=ranks.TIMEOUT_S),
    )
    return backend


def shutdown_distributed():
    """Leave the default process group: a barrier, so that no rank tears
    the group down under another's collective, then
    destroy_process_group().  Does nothing when no group is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def mesh_all_hosts(dp_per_host=None):
    """Global ("host", "dp") grid of ranks: hosts over the network, the
    ranks of one host (one a card) along "dp".  dp_per_host=None takes
    every rank to be on one host; otherwise the world must be a multiple
    of it."""
    import torch.distributed as dist

    from . import ranks

    world = dist.get_world_size()
    dp = dp_per_host or world
    if world % dp:
        raise ValueError(f"{world} ranks are no multiple of dp_per_host={dp}")
    return ranks.rank_grid(world // dp, dp, ("host", "dp"))


def shard_gop_ranges(n_gops, n_processes):
    """Contiguous GOP ranges per process (the work decomposition):
    ceil(n_gops / n_processes) each, the last ones short or empty."""
    per = -(-n_gops // n_processes)
    return [
        (min(i * per, n_gops), min((i + 1) * per, n_gops))
        for i in range(n_processes)
    ]


def global_metrics_psum(local_metrics, group=None):
    """All-rank reduction of per-rank metric vectors (billing/bytes/bins).
    local_metrics: float32[K] on each rank; returns the global sum as
    numpy, the same on every rank.  The rows are gathered and summed in
    rank order on the host, as the JAX function does, so a float32 result
    is bit for bit the same as its."""
    import torch
    import torch.distributed as dist

    from . import ranks

    dev = ranks.collective_device(group)
    row = torch.as_tensor(np.ascontiguousarray(local_metrics)).to(dev)
    rows = [torch.empty_like(row) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, row, group=group)
    return np.stack([r.cpu().numpy() for r in rows]).sum(axis=0)


def allgather_bytes(payload, group=None):
    """Every rank's bytes on every rank, in rank order: the lengths first,
    then the payloads padded to the longest (all_gather needs equal
    shapes)."""
    import torch
    import torch.distributed as dist

    from . import ranks

    dev = ranks.collective_device(group)
    world = dist.get_world_size(group)
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n, group=group)
    lens = [int(x) for x in lens]
    buf = np.zeros(max(max(lens), 1), np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    buf = torch.from_numpy(buf).to(dev)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf, group=group)
    return [b.cpu().numpy()[:k].tobytes() for b, k in zip(bufs, lens)]


def compress_sharded(data, process_id, num_processes, threads=0):
    """Per-process compression of this process's contiguous GOP range.

    The cheap GOP index (NAL + slice-header scan, native.gop_count) gives
    the work decomposition; this process then parses and recodes ONLY its
    GOPs (native.compress_gops), returning a container FRAGMENT: fragment
    0 carries the AVTR header, the fragment holding the last GOP carries
    the trailing literal, no fragment carries the end marker.  GOPs are
    entropy-independent at gop scope, so no cross-process state is
    exchanged; only the fragments themselves travel (allgather_bytes) for
    stitch().

    Returns fragment bytes (b"" for an empty shard when processes > GOPs)."""
    from ..host import native

    n = max(1, native.gop_count(data))
    lo, hi = shard_gop_ranges(n, num_processes)[process_id]
    frag, _total = native.compress_gops(data, lo, hi, threads=threads)
    return frag


def stitch(fragments):
    """Assembly of ordered per-process fragments into one container: pure
    concatenation + the end marker.  Byte-identical to
    native.compress(data, scope='gop') whenever every slice recodes."""
    return b"".join(fragments) + bytes([KIND_END, 0])


def decompress_sharded(blob, process_id, num_processes, threads=0):
    """Per-process decompression of this process's contiguous GOP-group
    range, the decode-direction mirror of compress_sharded.

    GOP groups are self-contained at scope=gop (each carries its model
    stream; literals pass through), so each process decodes a SUB-CONTAINER
    assembled from the shared header plus its block byte range; stitching
    the per-process outputs by concatenation reproduces
    decompress(blob) byte-exactly.  Returns b"" for an empty shard."""
    blob = bytes(blob)
    scan = scan_gop_groups(blob)
    if scan is None:  # non-gop scope: process 0 decodes everything
        if process_id != 0:
            return b""
        return _decode_any(blob, threads)
    header_end, groups = scan
    lo, hi = shard_gop_ranges(len(groups), num_processes)[process_id]
    if lo >= hi:
        return b""
    sub = (
        blob[:header_end]
        + blob[groups[lo][0] : groups[hi - 1][1]]
        + bytes([KIND_END, 0])
    )
    return _decode_any(sub, threads)


def _decode_any(blob, threads):
    from ..host import native

    if native.available():
        return native.decompress(blob, threads)
    from ..codec import decompress

    return decompress(blob)


def stitch_decompressed(fragments):
    """Assembly of ordered per-process decoded fragments: pure
    concatenation, byte-identical to decompress(blob)."""
    return b"".join(fragments)


