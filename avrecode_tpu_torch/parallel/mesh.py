"""One process, several devices: the port's mesh.

The JAX package shards arrays over a jax.sharding.Mesh with one "dp" axis.
Here a mesh is a plain tuple of torch.devices, one entry a shard; entries
may repeat, and shards on one card then run on CUDA streams of their own.
Lanes and traces are independent by format, so a mesh needs no collective:
rows are cut into contiguous shards, every shard is uploaded to its device
and launched there, and all shards are drained afterwards in order.

(Several processes with one rank each are the other shape of parallelism:
parallel/ranks.py and parallel/multihost.py, over torch.distributed.)
"""

import collections
import contextlib
import functools

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


def check_mesh(mesh):
    """A mesh as a tuple of torch.devices (raises on an empty one, or on a
    card where there is none)."""
    mesh = tuple(resolve_device(d) for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one shard")
    return mesh


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
