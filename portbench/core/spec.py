"""Find a cell's files by the names in BENCHMARK.json.

A cell names a configuration (its file is given in `configs`) and a traffic
mix (`portbench/traffic/<traffic>.json`). The traffic mix names the entry
that drives the program (`portbench/entries/<entry>.py`), and the entry
names its reference (`portbench/references/<name>.py`) and the stages whose
least time the roofline readers take (`portbench/stages/<name>.py`). Every
metric is read by `portbench/metrics/<base>.py`, its name up to the first
dot, so that one reader serves each variant of a quantity
(`device_idle_pct`, `device_idle_pct.sharded`). So a cell or a metric is
added by adding files and entries, and no file here changes.
"""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KINDS = ("entries", "references", "stages", "metrics")


class Bench:
    """BENCHMARK.json of the checkout at `root`, and the files it names."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json at {self.root}")
        self.spec = json.loads(path.read_text())
        self._modules = {}

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json "
                       f"(it has {[c['name'] for c in self.spec['workloads']]})")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(self.path("traffic", name, ".json").read_text())

    def path(self, kind: str, name: str, suffix: str = ".py") -> Path:
        path = self.root / "portbench" / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no file {path.relative_to(self.root)} for {name!r}")
        return path

    def module(self, kind: str, name: str):
        """The module `portbench/<kind>/<name>.py`, loaded once (a name may
        hold dots, so it is loaded from its path)."""
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        key = (kind, name)
        if key not in self._modules:
            path = self.path(kind, name)
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[key] = module
        return self._modules[key]

    def reader(self, metric: str):
        """The reader of a metric: `portbench/metrics/<base>.py`, the base
        being the metric's name up to its first dot."""
        return self.module("metrics", metric.split(".")[0])

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics this cell reports (every one without a
        `workloads` key, and those that list the cell)."""
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics this cell reports: those that list it in
        their `workloads`, which every per-layer metric has."""
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]
