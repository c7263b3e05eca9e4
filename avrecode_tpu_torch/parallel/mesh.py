"""One process, several devices: the port's mesh.

The JAX package shards arrays over a jax.sharding.Mesh with one "dp" axis.
Here a mesh is a plain tuple of torch.devices, one entry a shard; entries
may repeat, and shards on one card then run on CUDA streams of their own.
A device is a mesh of one.  Traces and lanes are independent by format, so
a mesh needs no collective: run_sharded, the one shard loop, cuts the items
into contiguous shards, dispatches every shard on its device and reads all
back afterwards in order.

device_compress cuts traces, not lanes: each shard runs the one-device
stage on its traces, and the lane path packs a shard's traces straight
into its dispatch groups, whose rows could not be cut again without a
second pack.  The grain is therefore coarser than the lane axis (a clip of
one GOP, one trace, uses one shard whatever the mesh).

(Several processes with one rank each are the other shape of parallelism:
parallel/ranks.py and parallel/multihost.py, over torch.distributed.)
"""

import collections
import contextlib
import functools
import inspect

import torch

from .. import resolve_device
from .multihost import shard_gop_ranges


def make_mesh(n_devices=None, device=None):
    """The "dp" mesh, a tuple of torch.devices.

    device=None: the first n_devices visible cards (all of them for None);
    raises when fewer are present.  A named device ("cuda:0", "cpu"):
    n_devices shards (1 for None) on that one device, on a card each with a
    CUDA stream of its own; this is asked for, never chosen silently."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    if device is not None:
        return (resolve_device(device),) * (n_devices or 1)
    resolve_device(None)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise RuntimeError(
            f"no CUDA device for {n - have} of the {n} shards ({have} "
            f"present); name one device to put several shards on it"
        )
    return tuple(torch.device("cuda", i) for i in range(n))


def shard_ranges(n_rows, n_shards):
    """Contiguous (lo, hi) row ranges, one a shard: ceil(n_rows / n_shards)
    rows each, the last ones short or empty (the layout of an array padded
    to a multiple of n_shards and cut evenly, without the padding; the
    same cut as multihost's GOP ranges)."""
    return shard_gop_ranges(n_rows, n_shards)


@functools.cache
def _card_stream(dev, k):
    """The k-th shard stream of a card, made once: torch keeps a memory
    pool a stream, so a mesh that came with new streams every call would
    allocate its working memory anew every call."""
    return torch.cuda.Stream(dev)


def shard_streams(mesh):
    """A CUDA stream for every shard on a card (the k-th shard of a card
    always gets the same one), None for a CPU shard."""
    seen = collections.Counter()
    streams = []
    for dev in mesh:
        if dev.type != "cuda":
            streams.append(None)
            continue
        streams.append(_card_stream(dev, seen[dev]))
        seen[dev] += 1
    return streams


@contextlib.contextmanager
def on_shard(stream):
    """Run the body on a shard's stream (and so on its card); a CPU shard
    (None) needs nothing."""
    if stream is None:
        yield
    else:
        with torch.cuda.stream(stream):
            yield


def as_mesh(device=None, mesh=None):
    """The mesh of a call that takes a device or a mesh, not both: the
    mesh as a tuple of torch.devices (raises on an empty one, or on a card
    where there is none), or the device as a mesh of one."""
    if mesh is None:
        return (resolve_device(device),)
    if device is not None:
        raise ValueError("give mesh or device, not both")
    mesh = tuple(resolve_device(d) for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one shard")
    return mesh


def run_sharded(n_items, mesh, dispatch, collect):
    """The mesh's shard loop: items [0, n_items) cut by shard_ranges, then
    dispatch(lo, hi, dev) for each non-empty shard on its stream, then
    collect(handle) for each in shard order on the same stream; returns
    the collected results in shard order.  No items still go to the first
    device, as one empty shard.  A mesh of one entry runs on the caller's
    current stream, as a call without a mesh would.

    A dispatch that waits for its own device between groups is a
    generator: it yields between its groups and returns its handle.
    The shards' generators are run in turns, a group each, so that one
    shard's wait holds back no other shard's dispatch."""
    streams = [None] if len(mesh) == 1 else shard_streams(mesh)
    shards = [(dev, stream, lo, hi) for dev, stream, (lo, hi) in zip(
        mesh, streams, shard_ranges(n_items, len(mesh))) if hi > lo]
    work = []
    for dev, stream, lo, hi in shards or [(mesh[0], streams[0], 0, 0)]:
        with on_shard(stream):
            work.append([stream, dispatch(lo, hi, dev)])
    turns = [w for w in work if inspect.isgenerator(w[1])]
    while turns:
        for w in list(turns):
            with on_shard(w[0]):
                try:
                    next(w[1])
                except StopIteration as done:
                    w[1] = done.value
                    turns.remove(w)
    out = []
    for stream, handle in work:
        with on_shard(stream):
            out.append(collect(handle))
    return out
