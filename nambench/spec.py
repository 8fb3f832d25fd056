"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file under this package (``configs/<name>.json``,
``traffic/<name>.json``), and each metric a reader module
(``metrics/<name>.py``).  Nothing here knows any cell: a new cell, mix or
metric is a new file and a new entry, never an edit.  ``later.json``
keeps, in the same form, the entries of cells withdrawn from the
benchmark, whole (their configurations and the metrics only they
report): the tests and ``controls.py`` may enter them, a run of the
benchmark never does.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
SECTIONS = ("configs", "workloads", "end_to_end", "per_layer")


def with_later(raw: dict, package: Path = PACKAGE) -> dict:
    """``raw`` (a ``BENCHMARK.json``) with ``later.json``'s entries
    appended to its sections."""
    later = json.loads((Path(package) / "later.json").read_text())
    return {k: v + later.get(k, []) if k in SECTIONS else v
            for k, v in raw.items()}


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    workloads: tuple | None      # None: every cell that reports `moves`
    moves: str | None = None     # per-layer metrics only


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Spec:
    """The benchmark as ``BENCHMARK.json`` (at ``root``) declares it, with
    its files under ``package``; with ``later``, its withdrawn cells
    too."""

    def __init__(self, root: Path = ROOT, package: Path = PACKAGE,
                 later: bool = False):
        self.root = Path(root)
        self.package = Path(package)
        self.raw = json.loads((self.root / "BENCHMARK.json").read_text())
        if later:
            self.raw = with_later(self.raw, self.package)
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"],
                                      int(w["chips"]))
                      for w in self.raw["workloads"]}
        self.end_to_end = [self._metric(m) for m in self.raw["end_to_end"]]
        self.per_layer = [self._metric(m) for m in self.raw["per_layer"]]

    @staticmethod
    def _metric(m: dict) -> Metric:
        wl = m.get("workloads")
        return Metric(m["name"], m["unit"], None if wl is None else tuple(wl),
                      m.get("moves"))

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def _json(self, folder: str, name: str) -> dict:
        path = self.package / folder / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"{folder} file {path} not found")
        return json.loads(path.read_text())

    def end_to_end_of(self, cell: str) -> list:
        """The end-to-end metrics the cell reports (``setup_s`` and those
        that list it or list no cells)."""
        return [m for m in self.end_to_end
                if m.workloads is None or cell in m.workloads]

    def per_layer_of(self, cell: str) -> list:
        """The per-layer metrics read in the cell's traced run: those that
        list it, and those with no list whose ``moves`` it reports."""
        mine = {m.name for m in self.end_to_end_of(cell)}
        return [m for m in self.per_layer
                if (cell in m.workloads if m.workloads is not None
                    else m.moves in mine)]

    def reader(self, metric: str):
        """The metric's reader: ``metrics/<metric>.py``'s ``read``."""
        path = self.package / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader {path} for metric {metric}")
        spec = importlib.util.spec_from_file_location(
            "nambench.metrics._" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def kernel_names(self, metric: str) -> tuple:
        """The device kernels a roofline metric sums, as data
        (``metrics/<metric>.kernels.json``: a list of names)."""
        path = self.package / "metrics" / f"{metric}.kernels.json"
        return tuple(json.loads(path.read_text()))
