"""The benchmark of avrecode_tpu_torch: one run of one cell of BENCHMARK.json
(python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1).

Everything a cell is made of is found by name: configs/<config>.json (the
deployment and its input pool), traffic/<mix>.json (how the work is sent),
metrics/<metric>.py (one reader a metric).  harness/ holds the general code,
reference/ the plain reference that decides `correct`."""
