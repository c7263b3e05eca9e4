"""Entry point of the port: the single-device step.

entry(device=None) -> (fn, example_args): the flagship device step, the
lane-parallel estimator-free entropy coder (ops/lane_coder.py): bare range
coding of (bit, p1) sub-streams by lane_encode, then the on-device
finalize.  Counterpart of the JAX package's entry(), on the same fixed
(8, 256) problem from RandomState(0); the arguments are the port's compact
lane problem (uint16 p1, int32 bit words, int32 lens) on `device`.
"""

import numpy as np

from . import resolve_device
from .ops.lane_coder import (
    finalize_device,
    from_numpy_problem,
    lane_encode,
    pack_compact,
)


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
