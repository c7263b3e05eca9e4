"""Block geometry: 4x4/8x8 block coordinates, zigzag scans, neighbor lookup.

Pure index math, the analog of the reference's scan8/zigzag table block
(recode.cpp:240-621 / C6) but defined directly on (x4, y4) grid coordinates
instead of ffmpeg's scan8 layout — gather-friendly arrays for the TPU model.
"""

import numpy as np

# luma4x4BlkIdx (Z-order within MB, clause 6.4.3) -> (x4, y4) in units of 4px
BLK4_X = np.array([2 * ((i >> 2) & 1) + (i & 1) for i in range(16)], dtype=np.int32)
BLK4_Y = np.array([2 * (i >> 3) + ((i >> 1) & 1) for i in range(16)], dtype=np.int32)
# inverse: (y4 * 4 + x4) -> blkIdx
RASTER_TO_BLK4 = np.zeros(16, dtype=np.int32)
for _i in range(16):
    RASTER_TO_BLK4[BLK4_Y[_i] * 4 + BLK4_X[_i]] = _i

# 8x8 block idx -> (x8, y8)
BLK8_X = np.array([0, 1, 0, 1], dtype=np.int32)
BLK8_Y = np.array([0, 0, 1, 1], dtype=np.int32)


def zigzag(n):
    """Zigzag scan order for an n*n block: scan position -> raster index."""
    order = sorted(
        range(n * n),
        key=lambda i: (
            (i // n) + (i % n),
            (i % n) if ((i // n) + (i % n)) % 2 else -(i // n),
        ),
    )
    return np.array(order, dtype=np.int32)


ZIGZAG_4x4 = zigzag(4)
ZIGZAG_8x8 = zigzag(8)


def mb_neighbors(mbx, mby, width_mbs):
    """(A=left, B=top) MB coords; None if outside picture."""
    a = (mbx - 1, mby) if mbx > 0 else None
    b = (mbx, mby - 1) if mby > 0 else None
    return a, b


def blk4_neighbor(mbx, mby, blk, dx, dy):
    """Neighbor 4x4 luma block at offset (dx, dy) in 4px units.

    Returns ((nmbx, nmby), nblk) — the neighbor may live in another MB —
    or None if it falls outside the picture edge handled by caller
    (negative MB coords are returned for the caller's availability check).
    """
    x = int(BLK4_X[blk]) + dx
    y = int(BLK4_Y[blk]) + dy
    nmbx, nmby = mbx, mby
    if x < 0:
        nmbx -= 1
        x += 4
    elif x > 3:
        nmbx += 1
        x -= 4
    if y < 0:
        nmby -= 1
        y += 4
    elif y > 3:
        nmby += 1
        y -= 4
    return (nmbx, nmby), int(RASTER_TO_BLK4[y * 4 + x])


def chroma_blk_neighbor(mbx, mby, blk, dx, dy, grid_h=2):
    """Neighbor 4x4 chroma block (2x2 grid for 4:2:0, 2x4 for 4:2:2)."""
    x = (blk & 1) + dx
    y = (blk >> 1) + dy
    nmbx, nmby = mbx, mby
    if x < 0:
        nmbx -= 1
        x += 2
    elif x > 1:
        nmbx += 1
        x -= 2
    if y < 0:
        nmby -= 1
        y += grid_h
    elif y > grid_h - 1:
        nmby += 1
        y -= grid_h
    return (nmbx, nmby), y * 2 + x
