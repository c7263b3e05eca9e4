"""Lane-parallel device entropy DECODER (PyTorch + CUDA), the dual of
ops/lane_coder.py.

Counterpart of avrecode_tpu/ops/lane_decoder.py, with the same function
names.  Given per-bin probabilities, container-v2 sub-streams are
independent serial recurrences, so the decode direction runs one range
decoder per lane, stepped over the bin axis.  The decoder is the exact
integer mirror of ops/rangecoder.RangeDecoder and is defined on any byte
string, not only on encoder output; a read past a lane's end yields zero
bytes (the encoder strips trailing zeros, so that is the normal case).

Forms of the per-bin step, all bit-identical:

  * lane_decode        kernel wrapper: the CUDA kernel csrc/lane_decode.cu
                       for CUDA tensors (the JAX package runs an XLA scan
                       here; a GPU thread indexes its own byte stream), the
                       plain version for CPU tensors
  * lane_decode_plain  a loop over bins, vectorised over lanes (mirror of
                       the JAX lane_decode_scan), a gather for the byte feed
  * the host decoder   ops/rangecoder.RangeDecoder

The device layout is the port's own (the "decode problem"):

  stream uint8  [N]         every lane's bytes, concatenated; N % 16 == 0
  offs   int64  [L + 1]     lane l owns stream[offs[l] : offs[l + 1]]
                            (clamped to [0, N] and to each other)
  p1     uint16 [L, Bp]     per-bin probability of a 1, Bp % 32 == 0
  lens   int32  [L]         valid bins per lane
  ->     int32  [L, Bp/32]  decoded bits, little-endian 32-bit words, 0
                            beyond lens

A lane's width is not bounded by the encoder's MAX_B: a v1 container
(substream_bins = 0) is one lane of all the bins of a scope unit.

torch defines no int32 overflow, so the plain version holds uint32 values
in int64 tensors with explicit & 0xFFFFFFFF masks; a plain compare is then
the unsigned compare the JAX version builds from a sign flip.
"""

import numpy as np
import torch

from ..parallel.mesh import as_mesh, run_sharded
from .lane_coder import CHUNK, _upload

TOP = 1 << 24
_M32 = 0xFFFFFFFF


def decode_step(code, rng, pos, byte_at, p1, v):
    """One range-decoder bin on a vector of lanes (exact mirror of
    RangeDecoder.get).

    code/rng/pos/p1: int64 [L], code and rng holding uint32 values; v: bool
    [L]; byte_at(pos) gives each lane's stream byte at its own position (0
    past the lane's end).  The second renorm step reads at the position the
    first one advanced to.  Lanes with v False keep their state and decode
    to 0.  Returns (code, rng, pos, bit)."""
    r1 = ((rng >> 16) & 0xFFFF) * p1
    bit = code < r1
    code_n = torch.where(bit, code, (code - r1) & _M32)
    rng_n = torch.where(bit, r1, (rng - r1) & _M32)

    do0 = rng_n < TOP
    code_n = torch.where(do0, ((code_n << 8) & _M32) | byte_at(pos), code_n)
    rng_n = torch.where(do0, (rng_n << 8) & _M32, rng_n)
    pos_n = pos + do0

    do1 = rng_n < TOP
    code_n = torch.where(do1, ((code_n << 8) & _M32) | byte_at(pos_n), code_n)
    rng_n = torch.where(do1, (rng_n << 8) & _M32, rng_n)
    pos_n = pos_n + do1

    code = torch.where(v, code_n, code)
    rng = torch.where(v, rng_n, rng)
    pos = torch.where(v, pos_n, pos)
    return code, rng, pos, torch.where(v, bit, False).to(torch.int64)


def byte_feed(stream, offs):
    """byte_at(pos) for decode_step: lane l's byte stream[offs[l] + pos[l]]
    as int64, 0 at and past offs[l + 1].  Offsets are clamped to [0, N] and
    to each other, as the kernel clamps them."""
    N = stream.numel()
    data = torch.cat([stream.to(torch.int64),
                      torch.zeros(1, dtype=torch.int64, device=stream.device)])
    start = offs[:-1].clamp(0, N)
    end = torch.maximum(offs[1:].clamp(max=N), start)

    def byte_at(pos):
        idx = start + pos
        return data[torch.where(idx < end, idx, N)]

    return byte_at


def _check_problem(stream, offs, p1u16, lens):
    """The wrapper's contract: the decode problem, contiguous, on one
    device, with N a multiple of 16 and Bp a multiple of 32."""
    dtypes = (stream.dtype, offs.dtype, p1u16.dtype, lens.dtype)
    if dtypes != (torch.uint8, torch.int64, torch.uint16, torch.int32):
        raise TypeError(
            "decode problem must be (uint8 stream, int64 offs, uint16 p1, "
            f"int32 lens), got {', '.join(map(str, dtypes))}"
        )
    if p1u16.dim() != 2:
        raise ValueError(f"p1u16 must be [L, B], got {tuple(p1u16.shape)}")
    L, Bp = p1u16.shape
    if Bp % 32 or Bp >= 1 << 31:
        raise ValueError(f"B={Bp} must be a multiple of 32 below 2^31")
    if stream.dim() != 1 or stream.numel() % 16:
        raise ValueError(
            f"stream must be one row of bytes, a multiple of 16 long, got "
            f"{tuple(stream.shape)}"
        )
    if tuple(offs.shape) != (L + 1,) or tuple(lens.shape) != (L,):
        raise ValueError(
            f"shapes {tuple(offs.shape)}, {tuple(p1u16.shape)}, "
            f"{tuple(lens.shape)} are not [L + 1], [L, B], [L]"
        )
    tensors = (stream, offs, p1u16, lens)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode problem tensors must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("decode problem tensors must share one device")


def pack_bits(bits):
    """[L, Bp] 0/1 values (Bp % 32 == 0) -> int32 [L, Bp/32] little-endian
    bit words."""
    L, Bp = bits.shape
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.to(torch.int64).reshape(L, Bp // 32, 32) << shifts).sum(dim=2)
    return torch.where(words >> 31 != 0, words - (1 << 32), words).to(torch.int32)


def unpack_bits(bitw, B=None):
    """int32 [L, Bp/32] bit words (tensor or numpy) -> numpy uint8 [L, B]
    bits (B defaults to Bp)."""
    if isinstance(bitw, torch.Tensor):
        bitw = bitw.cpu().numpy()
    words = np.ascontiguousarray(bitw, np.int32)
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    return bits if B is None else bits[:, :B]


def lane_decode_plain(stream, offs, p1u16, lens):
    """Plain torch version of the lane decode kernel: a Python loop over
    bins, vectorised over lanes (mirror of the JAX lane_decode_scan), with a
    gather for the byte feed.  Takes the decode problem, returns int32
    [L, Bp/32] bit words."""
    _check_problem(stream, offs, p1u16, lens)
    L, Bp = p1u16.shape
    dev = p1u16.device
    bits = torch.zeros((Bp, L), dtype=torch.uint8, device=dev)
    if L and Bp:
        byte_at = byte_feed(stream, offs)
        p1 = p1u16.to(torch.int64).T.contiguous()
        lens = lens.to(torch.int64)
        # init: code = the first 4 bytes, big-endian (RangeDecoder.__init__)
        code = torch.zeros(L, dtype=torch.int64, device=dev)
        pos = torch.zeros_like(code)
        for _ in range(4):
            code = (code << 8) | byte_at(pos)
            pos = pos + 1
        rng = torch.full_like(code, _M32)
        # bins past the longest lane's end decode to 0 on every lane
        for i in range(min(Bp, max(int(lens.max()), 0))):
            code, rng, pos, bits[i] = decode_step(
                code, rng, pos, byte_at, p1[i], i < lens)
    return pack_bits(bits.T)


def lane_decode(stream, offs, p1u16, lens):
    """Kernel wrapper: range-decode every lane of the decode problem.

    CUDA tensors launch the CUDA kernel (built at first use; raises if it
    cannot build or launch), on the current stream without synchronising.
    CPU tensors run lane_decode_plain.  Same contract and output as
    lane_decode_plain; lane_decode.launches counts kernel launches."""
    _check_problem(stream, offs, p1u16, lens)
    dev = p1u16.device
    if dev.type == "cpu":
        return lane_decode_plain(stream, offs, p1u16, lens)
    if dev.type != "cuda":
        raise ValueError(f"lane_decode takes cuda or cpu tensors, not {dev}")
    if p1u16.data_ptr() % 16 or stream.data_ptr() % 16:
        raise ValueError("p1u16 and stream must start on a 16-byte boundary "
                         "(the kernel copies them in 16-byte pieces)")
    from ._build import load

    lib = load()
    L, Bp = p1u16.shape
    bitw = torch.empty((L, Bp // 32), dtype=torch.int32, device=dev)
    if L == 0 or Bp == 0:
        return bitw
    with torch.cuda.device(dev):
        err = lib.lane_decode_launch(
            stream.data_ptr(), stream.numel(), offs.data_ptr(),
            p1u16.data_ptr(), lens.data_ptr(), bitw.data_ptr(), L, Bp,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"lane_decode kernel launch failed: cudaError {err} "
            f"({lib.kernel_error_string(err).decode()})"
        )
    lane_decode.launches += 1
    return bitw


lane_decode.launches = 0


# ---------------------------------------------------------------------------
# Host-side packing of the decode problem


def to_p1u16(p1s):
    """Integer p1 values (any shape) -> uint16; raises on a value outside
    [0, 0xFFFF] (p1 comes from Python ints on the decompress path)."""
    p1s = np.asarray(p1s)
    if p1s.dtype.kind not in "iu":
        raise TypeError(f"p1 must be integers, got {p1s.dtype}")
    if p1s.size and (int(p1s.min()) < 0 or int(p1s.max()) > 0xFFFF):
        raise ValueError(
            f"p1 must lie in [0, 0xFFFF], got {int(p1s.min())}.."
            f"{int(p1s.max())}"
        )
    return p1s.astype(np.uint16)


def pack_streams(stream_list):
    """Per-lane stream bytes -> (uint8 [N] concatenated buffer, zero-padded
    to a multiple of 16 bytes and never empty, int64 [L + 1] offsets)."""
    offs = np.zeros(len(stream_list) + 1, np.int64)
    np.cumsum([len(s) for s in stream_list], out=offs[1:])
    n = int(offs[-1])
    buf = np.zeros(-(-max(n, 1) // 16) * 16, np.uint8)
    buf[:n] = np.frombuffer(b"".join(stream_list), np.uint8)
    return buf, offs


def pack_decode_problem(stream_list, p1s, lens):
    """Host-side packing: per-lane stream bytes, [L, B] integer p1 and [L]
    bin counts -> the numpy decode problem (stream, offs, p1u16, lens), the
    bin axis zero-padded to a multiple of CHUNK."""
    p1u16 = to_p1u16(p1s)
    if p1u16.ndim != 2 or p1u16.shape[0] != len(stream_list):
        raise ValueError(
            f"p1 must be [L, B] with one row per stream, got "
            f"{p1u16.shape} for {len(stream_list)} streams"
        )
    B = p1u16.shape[1]
    Bp = -(-max(B, 1) // CHUNK) * CHUNK
    if Bp != B:
        p1u16 = np.pad(p1u16, ((0, 0), (0, Bp - B)))
    lens = np.asarray(lens, np.int32).reshape(-1)
    if lens.shape[0] != len(stream_list):
        raise ValueError(f"{lens.shape[0]} lens for {len(stream_list)} streams")
    return (*pack_streams(stream_list), p1u16, lens)


def problem_from_padded(streams, p1s, lens):
    """The JAX package's numpy decode problem ([L, M] int32 stream bytes,
    zero-padded rows; [L, B] int32 p1; [L] lens), as lane_decode_scan takes
    it, -> the port's numpy decode problem.  Every lane keeps its whole
    padded row: trailing zeros decode like the end of the stream."""
    rows = np.asarray(streams)
    if rows.size and (rows.min() < 0 or rows.max() > 0xFF):
        raise ValueError("stream rows must hold byte values")
    rows = rows.astype(np.uint8)
    return pack_decode_problem([r.tobytes() for r in rows], p1s, lens)


def from_numpy_problem(stream, offs, p1u16, lens, device):
    """Numpy decode problem -> the port's tensors on `device` (CUDA uploads
    go through pinned memory without blocking the host)."""
    dev = torch.device(device)
    return tuple(
        _upload(np.asarray(a, t), dev)
        for a, t in ((stream, np.uint8), (offs, np.int64),
                     (p1u16, np.uint16), (lens, np.int32))
    )


def decode_streams_lanes(stream_list, p1s, lens, device=None, mesh=None):
    """Host side: pack per-lane stream bytes (list of bytes objects) with
    their [L, B] p1 and [L] bin counts, and decode on `device`.  Returns
    int32 [L, B] bits on that device, 0 beyond lens (equal in value to the
    JAX decode_streams_lanes).

    mesh (parallel/mesh.make_mesh; not together with device; a device is a
    mesh of one) cuts the lanes into one contiguous shard a mesh entry
    (mesh.run_sharded): every non-empty shard is packed and uploaded to its
    device and decoded there by one lane_decode launch, then all are joined
    on the first entry's device.  Lanes are independent, so no collective
    is needed."""
    mesh = as_mesh(device, mesh)
    stream_list = list(stream_list)
    L = len(stream_list)
    p1s = np.asarray(p1s)
    B = int(p1s.shape[1]) if L else 0
    p1s = p1s.reshape(L, B)
    lens = np.asarray(lens, np.int32).reshape(-1)

    def dispatch(lo, hi, dev):
        prob = pack_decode_problem(stream_list[lo:hi], p1s[lo:hi],
                                   lens[lo:hi])
        return lane_decode(*from_numpy_problem(*prob, dev))

    def collect(bitw):
        if bitw.is_cuda:  # the shard's stream, before another reads it
            torch.cuda.current_stream(bitw.device).synchronize()
        return bitw.to(mesh[0])

    parts = run_sharded(L, mesh, dispatch, collect)
    bitw = torch.cat(parts)
    shifts = torch.arange(32, dtype=torch.int32, device=bitw.device)
    bits = (bitw[:, :, None] >> shifts) & 1
    return bits.reshape(bitw.shape[0], 32 * bitw.shape[1])[:, :B]
