"""PyTorch + CUDA port of avrecode-tpu, the lossless H.264 recompressor.

The JAX package (`avrecode_tpu`) stays the reference.  This package stands
alone: it imports neither jax nor any module of `avrecode_tpu`.  It keeps
its own copy of the host layer under the same module paths (`codec`,
`host/` with the C++ mirror built at first use, `h264/`, `models/`,
`utils/`, and the tables and host coders in `ops/`), and ports the device
layer, with the same module paths and function names:

  ops/lane_coder.py     lane-parallel estimator-free range coder; the CUDA
                        kernel in csrc/lane_encode.cu replaces the Pallas
                        `_lane_kernel`, and the one in csrc/lane_streams.cu
                        (encode and finalize in one launch, the main path)
                        replaces `_lane_pipeline_jit`
  ops/estimator.py      est-on-device model + range coder, plain torch
                        (counterpart of ops/estimator_jax.py)
  ops/est_coder.py      est kernel wrapper, packing, host finalize; the CUDA
                        kernel in csrc/est_encode.cu replaces the Pallas
                        `pallas_coder._kernel`
  ops/lane_decoder.py   lane-parallel range decoder, the dual of
                        ops/lane_coder.py; the CUDA kernel in
                        csrc/lane_decode.cu does what the JAX package's XLA
                        scan `lane_decode_scan` does
  parallel/pipeline.py  device_compress (both paths, on one device or
                        sharded over a mesh), device_compress_corpus,
                        device_decompress (host model pass, device entropy
                        decode, host assembly), and multichip_step, the
                        sharded est step every rank of a group calls
  parallel/mesh.py      one process, several devices: make_mesh, a tuple of
                        torch.devices; several shards on one card run on
                        CUDA streams of their own; no collectives
  parallel/ranks.py     several processes, one rank each, over
                        torch.distributed: the backend rule (nccl when every
                        rank owns a card, gloo when ranks share one or the
                        CPU is asked for), grids of ranks, run_ranks
  parallel/multihost.py init_distributed, mesh_all_hosts, the metrics
                        reduction, and GOP ranges across processes
                        (compress_sharded / stitch and the decode mirror)
  graft_entry.py        entry(): the single-device step, lane_encode +
                        finalize_device on a fixed (8, 256) problem;
                        dryrun_multichip(n): n ranks on this machine run
                        the sharded lane step and its collectives
  cli.py, __main__.py   python -m avrecode_tpu_torch {compress|decompress|
                        roundtrip|test}: host code, as in the JAX package

`compress` / `decompress` below are the package-level host calls.
`tools/gpu_verify.py` runs the byte-identity checks on a card and writes
GPU_VERIFY.json.

Every public device entry takes an explicit `device` (or a mesh made with
one).  None or "cuda" needs a card and raises without one; the plain torch
path runs only when "cpu" is asked for.  Importing the package loads no
torch: the command line is host code.
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """None / "cuda" -> torch.device("cuda") (raises when no card is
    present); anything else is taken as given ("cpu" must be explicit)."""
    import torch  # not at import time: the command line is host code

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch path"
        )
    return dev


def compress(data, scope="gop", threads=0):
    """Compress on the host (native library when built, Python reference
    otherwise)."""
    from .host import native

    if native.available():
        return native.compress(data, scope, threads)
    from .codec import compress as py_compress

    return py_compress(data, scope=scope)


def decompress(blob, threads=0):
    """Decompress a recoded container back to the original bytes."""
    from .host import native

    if native.available():
        return native.decompress(blob, threads)
    from .codec import decompress as py_decompress

    return py_decompress(blob)
