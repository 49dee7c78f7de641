"""``BENCHMARK.json``: loading, the checks on names and units, and the
lookup of a cell's configuration, traffic mix and metrics.

A cell names a configuration (``benchmark/configs/<file>``) and a traffic
mix (``benchmark/traffic/<traffic>.json``); a per-layer metric is read by
``benchmark/metrics/<name>.py``. Everything is found by name, so a new
cell, mix or metric is new files plus entries here.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class ManifestError(ValueError):
    pass


def _name(value, what: str) -> str:
    if not isinstance(value, str) or not NAME_RE.fullmatch(value):
        raise ManifestError(f"{what}: {value!r} is not a name (letters, digits, _ . -; at most 64)")
    return value


def _metric(m: dict, kind: str, e2e_names: set[str]) -> dict:
    _name(m.get("name"), f"{kind} metric")
    if not isinstance(m.get("unit"), str) or not UNIT_RE.fullmatch(m["unit"]):
        raise ManifestError(f"metric {m['name']}: unit {m.get('unit')!r} is not a unit")
    if m.get("better") not in ("lower", "higher"):
        raise ManifestError(f"metric {m['name']}: better must be lower or higher")
    if m.get("source") not in SOURCES:
        raise ManifestError(f"metric {m['name']}: unknown source {m.get('source')!r}")
    if kind == "end_to_end" and m["source"] not in ("host_clock", "device_trace"):
        raise ManifestError(f"metric {m['name']}: an end-to-end metric comes from host_clock or device_trace")
    if kind == "per_layer" and m.get("moves") not in e2e_names:
        raise ManifestError(f"metric {m['name']}: moves {m.get('moves')!r} is no end-to-end metric")
    return m


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def load(path: Path | None = None) -> dict:
    """Read and check ``BENCHMARK.json``; raises :class:`ManifestError`."""
    path = path or ROOT / "BENCHMARK.json"
    try:
        man = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ManifestError(f"cannot read {path}: {e}") from e
    configs = {_name(c.get("name"), "config"): c for c in man.get("configs", [])}
    for c in man.get("workloads", []):
        _name(c.get("name"), "workload")
        _name(c.get("traffic"), "traffic")
        if c.get("config") not in configs:
            raise ManifestError(f"workload {c['name']}: unknown config {c.get('config')!r}")
        if c.get("chips") not in (1, 4):
            raise ManifestError(f"workload {c['name']}: chips must be 1 or 4")
    e2e = [_metric(m, "end_to_end", set()) for m in man.get("end_to_end", [])]
    e2e_names = {m["name"] for m in e2e}
    for m in man.get("per_layer", []):
        _metric(m, "per_layer", e2e_names)
    names = [m["name"] for m in e2e + man.get("per_layer", [])]
    if len(set(names)) != len(names):
        raise ManifestError("two metrics share a name")
    return man


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def limits(cell: Cell) -> dict:
    """The limits of ``correct`` for the cell's configuration and entry:
    ``benchmark/limits/<config>.<entry>.json``."""
    return json.loads((BENCH / "limits" / f"{cell.config_name}.{cell.traffic['entry']}.json").read_text())


def cell(man: dict, name: str) -> Cell:
    """The cell ``name`` with its configuration and traffic files read."""
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise ManifestError(f"no workload named {name!r}")
    w = found[0]
    cfg_entry = next(c for c in man["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in man["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, name) and m["moves"] in e2e_names]
    return Cell(name, w["config"], config, traffic, int(w["chips"]), e2e, per_layer)
