"""Device seconds of the est kernel (csrc/est_encode.cu,
est_encode_kernel) a MB of input finished in the window: the traced time
of the operations whose name holds est_encode_kernel, over the files'
input bytes, in s/MB."""
from benchmark.harness import readings

LAYER, MOVES, SOURCE = "est kernel", "compress_mb_s", "device_trace"


def read(rec):
    return readings.per_mb(rec, readings.kernel_s(rec, "est_encode_kernel"))
