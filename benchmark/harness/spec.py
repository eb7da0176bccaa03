"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file and its metric readers.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json`` and a metric ``metrics/<metric>.py`` (a
``read(run)`` function), so a cell, a configuration or a metric is added
by adding files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    workload: dict          # the BENCHMARK.json entry
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    end_to_end: list        # the metric entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    """A metric with a ``workloads`` key is reported in those cells only."""
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(bench: dict, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of the parsed ``BENCHMARK.json`` `bench`, with its
    configuration and traffic read from their files under `bench_dir`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell = files_cell(w, bench_dir.parent / entry["file"], bench_dir)
    cell.end_to_end = [m for m in bench["end_to_end"] if reports(m, name)]
    cell.per_layer = [m for m in bench["per_layer"] if reports(m, name)]
    return cell


def files_cell(workload: dict, config_file: Path,
               bench_dir: Path = BENCH_DIR) -> Cell:
    """A cell made of a workload entry ({name, config, traffic, chips})
    and its files alone, with no metrics: what a cell's loop runs, also
    for one that ``BENCHMARK.json`` does not list yet."""
    config = load_json(config_file)
    traffic = load_json(bench_dir / "traffic" / f"{workload['traffic']}.json")
    if config.get("name") != workload["config"]:
        raise ValueError(f"{config_file} holds config {config.get('name')!r}, "
                         f"not {workload['config']!r}")
    return Cell(workload=workload, config=config, traffic=traffic,
                end_to_end=[], per_layer=[])


def reader(metric_name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    path = bench_dir / "metrics" / f"{metric_name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric_name!r}: {path}")
    mod_name = "bench_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric_name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
