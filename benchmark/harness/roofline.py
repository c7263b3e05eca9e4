"""The least time the card could take for a launch of the fused lane kernel
(copied from chip_smoke.py's bound arithmetic, so that the yardstick does not
move with the program's files).

The card's peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): memory
at 3.35 TB/s, and integer operations at half the 67 TFLOP/s float32 rate
(an SM has half as many int32 lanes as float32 lanes)."""

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
# Integer operations of each lane algorithm, counted on the range coder's
# put (32-bit arithmetic, so masks are free, and a branch counts as one
# select), whatever a kernel's SASS spends: (ops a bin, ops a renorm step);
# a renorm step moves one byte, so a lane's steps are its stream bytes.
# - lane_encode_streams: a bin the coder's 10 (r1 2, low's add with its
#   carry test and count 3, rng's subtract 1, three selects 3, the loop's
#   test 1); a step the coder's 6, the byte stored and the position moved
#   2, its carry count added onto the byte before 1, the trailing-zero and
#   truncation scans 1: 10
# - lane_encode_streams_idx: the same, and a bin's 12-bit field taken out
#   and looked up in the squash table: 12 a bin
STREAM_OPS = (10, 10)
STREAM_IDX_OPS = (12, 10)
SQUASH_TABLE_BYTES = 4096 * 2


def lane_ops(per, n_bins, n_steps):
    """Integer operations of a lane algorithm over n_bins bins and n_steps
    renorm steps."""
    return per[0] * n_bins + per[1] * n_steps


def stream_bytes(rows, Bp, emitted, index):
    """Bytes one launch must move, each read or written once: the p1 in
    the upload form (the index form's 12-bit indices, 1.5 B a bin, and the
    squash table; or uint16 p1), the bit words, the lane lengths in, and the
    stream bytes, nbytes and total out."""
    p1 = rows * Bp * 3 // 2 + SQUASH_TABLE_BYTES if index else rows * Bp * 2
    return p1 + rows * Bp // 8 + rows * 4 + emitted + 2 * rows * 4


def bound_ms(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations"): the bytes at the card's
    memory rate against the integer operations at its rate for them."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def launch_bound_ms(rows, Bp, bins, emitted, index):
    """bound_ms of one launch of the fused kernel of the given form."""
    ops = lane_ops(STREAM_IDX_OPS if index else STREAM_OPS, bins, emitted)
    return bound_ms(stream_bytes(rows, Bp, emitted, index), ops)
