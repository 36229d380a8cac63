"""Finding a cell's files by its name in ``BENCHMARK.json``.

A cell (one entry of ``workloads``) is its configuration's file (named
by the ``configs`` entry), its own file of traffic parameters
(``ltpbench/workloads/<cell>.json``), the plain reference of its
configuration (``ltpbench/reference/<config>.py``) and the readers of
the metrics it reports (``ltpbench/metrics/<metric>.py``). A later cell,
configuration or metric is a new file and a new entry; nothing here
names one.

A cell whose files are here but that ``BENCHMARK.json`` does not list
(one held out until a fault of the program is mended) still loads, by
the convention that its name is ``<config>.<traffic>``, so that its
configuration and reference stay tested.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict[str, Any]       # the configuration's file
    workload: Dict[str, Any]     # the cell's traffic parameters
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int

    @property
    def reference(self):
        return importlib.import_module(
            f"ltpbench.reference.{self.config_name}")

    def limits(self) -> Dict[str, float]:
        return dict(self.workload["limits"])


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def on_disk() -> List[str]:
    """Every cell with a traffic file, listed in ``BENCHMARK.json`` or
    held out of it."""
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def load(name: str, *, root: Path = ROOT, test_sizes: bool = False) -> Cell:
    """The cell ``name``. With ``test_sizes`` its configuration and
    traffic take their ``cpu_test`` overrides: a size a CPU test run
    holds."""
    m = manifest(root)
    wl = next((w for w in m["workloads"] if w["name"] == name), None)
    if wl is None:
        if name not in on_disk():
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        wl = {"name": name, "config": name.split(".")[0], "chips": 1}
    cfg_file = next((c["file"] for c in m["configs"]
                     if c["name"] == wl["config"]),
                    f"ltpbench/configs/{wl['config']}.json")
    config = json.loads((root / cfg_file).read_text())
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if test_sizes:
        config = {**config, **config["cpu_test"]}
        workload = {**workload, **workload["cpu_test"]}
    return Cell(
        name=name, config_name=wl["config"], config=config,
        workload=workload,
        end_to_end=[e for e in m["end_to_end"] if _applies(e, name)],
        per_layer=[p for p in m["per_layer"] if _applies(p, name)],
        chips=int(wl["chips"]))


def reader(metric: str):
    """The ``read(ctx)`` function of ``ltpbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"ltpbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
