"""Finding a cell's parts by name.

A cell is an entry of BENCHMARK.json's `workloads`; it names a
configuration, found as configs/<name>.json, and a traffic mix, found as
traffic/<name>.json.  Every metric of BENCHMARK.json, end to end or per
layer, has a reader metrics/<name>.py, whose read(record) returns the
number or None.  A later cell, configuration, mix or metric is one more
file and one more entry: nothing here names any of them."""

import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MIX_KEYS = {"unit", "entry", "about"}
MIX_UNITS = ("job", "file")
MIX_ENTRIES = ("corpus", "file")


class Spec:
    """BENCHMARK.json and the directory its named files are found in."""

    def __init__(self, bench_json=None, base=None):
        self.path = pathlib.Path(bench_json or ROOT / "BENCHMARK.json")
        self.base = pathlib.Path(base or BENCH_DIR)
        self.data = json.loads(self.path.read_text())

    def cell(self, name):
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in {self.path}")

    def _json(self, kind, name):
        return json.loads((self.base / kind / f"{name}.json").read_text())

    def config(self, name):
        return self._json("configs", name)

    def mix(self, name):
        """A traffic mix: its `unit` (job or file) and `entry` (corpus or
        file), sent by one caller in a closed loop, and an `about`; a key
        that the window does not read is refused, so that a mix asking for
        something else never runs as this one."""
        mix = self._json("traffic", name)
        extra = set(mix) - MIX_KEYS
        if extra:
            raise ValueError(f"traffic mix {name!r}: keys {sorted(extra)} "
                             f"are not read by the window (it reads "
                             f"{sorted(MIX_KEYS)})")
        if mix["unit"] not in MIX_UNITS or mix["entry"] not in MIX_ENTRIES:
            raise ValueError(f"traffic mix {name!r}: unit {mix['unit']!r} "
                             f"or entry {mix['entry']!r} unknown")
        return mix

    def metrics(self, cell_name, trace):
        """The metrics a run of the cell reports: its end-to-end metrics
        untraced, its per-layer metrics traced (those whose `workloads`
        name the cell, or all where the key is absent)."""
        return [m for m in self.data["per_layer" if trace else "end_to_end"]
                if cell_name in m.get("workloads", [cell_name])]

    def reader(self, metric_name):
        """The module metrics/<name>.py (a name may hold dots, so it is
        loaded from its path, not imported by name)."""
        path = self.base / "metrics" / f"{metric_name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric_name.replace('.', '_')}", path)
        if spec is None:
            raise FileNotFoundError(path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
