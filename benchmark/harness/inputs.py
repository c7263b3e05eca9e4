"""The one general generator: a configuration's jobs, drawn from --seed.

A configuration's file names a pool of committed input files and the shape
of a job (one directory that the user hands the recompressor):

  {"kind": "recordings", "recording_gops": [[n, ...], ...]}
      one job a list, one recording a length: a recording is n GOP units
      of the pool (an Annex B stream cut by annexb_units), each unit used
      n / units times, in an order the seed draws.  The recordings are
      written once, during set-up, to a directory of the run's own, and the
      window sends the jobs in turn, from one the seed draws.

A job is a list of InputFile; `key` names the recording and `parts` the
units that the reference compresses for it (reference_inputs) and splices
into its expected container (expected)."""

import collections
import os

import numpy as np

InputFile = collections.namedtuple("InputFile", "path size key parts")

# seed streams, one a use, so that one draw never shifts another
_RECORDING, _OFFSET = 2, 3


def _rng(seed, *salt):
    return np.random.default_rng([seed & (2 ** 64 - 1), *salt])


def _nal_starts(data):
    """(position of the start code, NAL type) of each NAL of an Annex B
    stream; a 4-byte start code's leading zero belongs to the start code."""
    out, i, n = [], 0, len(data)
    while True:
        i = data.find(b"\x00\x00\x01", i)
        if i < 0 or i + 3 >= n:
            return out
        start = i - 1 if i and data[i - 1] == 0 else i
        out.append((start, data[i + 3] & 0x1F))
        i += 3


def annexb_units(data):
    """Cut an Annex B stream at each IDR that follows an SPS and a PPS: a
    unit starts at the start code of the SPS, and holds everything up to
    the next unit.  A unit is a closed GOP with its parameter sets, so any
    sequence of units is a valid stream.  Raises where the stream does not
    start with such a unit."""
    nals = _nal_starts(data)
    cuts, sps, pps = [], None, False
    for pos, typ in nals:
        if typ == 7:
            sps, pps = pos, False
        elif typ == 8:
            pps = sps is not None
        elif typ in (1, 5):
            if typ == 5 and pps and sps is not None:
                cuts.append(sps)
            sps, pps = None, False
    if not cuts or cuts[0] != 0:
        raise ValueError("the stream does not start with SPS, PPS and IDR")
    return [data[a:b] for a, b in zip(cuts, cuts[1:] + [len(data)])]


class Jobs:
    """The jobs of one configuration under one seed.  `workdir` receives
    the recordings; the caller removes it."""

    def __init__(self, config, base, seed, workdir):
        pool = config["pool"]
        job = config["job"]
        if job["kind"] != "recordings":
            raise ValueError(f"unknown job kind {job['kind']!r}")
        self.units = {}
        for name in pool["files"]:
            with open(os.path.join(base, pool["dir"], name), "rb") as f:
                for i, u in enumerate(annexb_units(f.read())):
                    self.units[f"{name}#{i}"] = u
        names = list(self.units)
        self._jobs = []
        for j, lengths in enumerate(job["recording_gops"]):
            files = []
            for r, n in enumerate(lengths):
                if n % len(names):
                    raise ValueError(f"a recording of {n} GOPs does not "
                                     f"use {len(names)} units evenly")
                seq = _rng(seed, _RECORDING, j, r).permutation(
                    np.repeat(np.arange(len(names)), n // len(names)))
                parts = tuple(names[i] for i in seq)
                path = os.path.join(workdir, f"recording_{j}_{r}.264")
                with open(path, "wb") as f:
                    for name in parts:
                        f.write(self.units[name])
                    # on disk before the window: no write-back in it
                    f.flush()
                    os.fsync(f.fileno())
                files.append(InputFile(path, os.path.getsize(path),
                                       f"recording_{j}_{r}", parts))
            self._jobs.append(files)
        self._offset = int(_rng(seed, _OFFSET).integers(len(self._jobs)))
        self.warm_files = config.get("warm_files")

    def job(self, k):
        """The k-th job of the window (k >= 0)."""
        return self._jobs[(self._offset + k) % len(self._jobs)]

    def warm_job(self):
        """The set-up's job: the window's first, cut to the configuration's
        `warm_files` first files where it names them."""
        files = self.job(0)
        return files[:self.warm_files] if self.warm_files else files

    def files(self):
        """Every file of the jobs 0, 1, 2, ... in order (a serial caller's
        stream)."""
        k = 0
        while True:
            yield from self.job(k)
            k += 1

    def reference_inputs(self):
        """{name: bytes} of everything the reference compresses: the
        recordings' GOP units."""
        return dict(self.units)

    def expected(self, keys, containers, splice):
        """{file key: the container it has to produce} for the files named
        by `keys`, from the reference's containers of reference_inputs()
        (`splice` joins the units' containers of a recording)."""
        parts = {f.key: f.parts for job in self._jobs for f in job}
        return {k: splice([containers[u] for u in parts[k]]) for k in keys}
