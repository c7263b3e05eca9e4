"""Seconds from the process's start to the window's start: imports, the
CUDA context, the program's libraries (built only where missing), the
inputs made from the seed, the warm-up."""
LAYER, MOVES, SOURCE = "end to end", "setup_s", "host_clock"


def read(rec):
    return rec["setup_seconds"]
