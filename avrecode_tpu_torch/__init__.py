"""PyTorch + CUDA port of avrecode-tpu, the lossless H.264 recompressor.

The JAX package (`avrecode_tpu`) stays the reference.  This package stands
alone: it imports neither jax nor any module of `avrecode_tpu`.  It keeps
its own copy of the host layer under the same module paths (`codec`,
`host/` with the C++ mirror built at first use, `h264/`, `models/`,
`utils/`, and the tables and host coders in `ops/`), and ports the device
layer, with the same module paths and function names:

  ops/lane_coder.py     lane-parallel estimator-free range coder; the CUDA
                        kernel in csrc/lane_encode.cu replaces the Pallas
                        `_lane_kernel`
  ops/estimator.py      est-on-device model + range coder, plain torch
                        (counterpart of ops/estimator_jax.py)
  ops/est_coder.py      est kernel wrapper, packing, host finalize; the CUDA
                        kernel in csrc/est_encode.cu replaces the Pallas
                        `pallas_coder._kernel`
  parallel/pipeline.py  device_compress (both paths) / device_compress_corpus

Every public entry takes an explicit `device`.  None or "cuda" needs a
card and raises without one; the plain torch path runs only when "cpu" is
asked for.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None):
    """None / "cuda" -> torch.device("cuda") (raises when no card is
    present); anything else is taken as given ("cpu" must be explicit)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch path"
        )
    return dev
