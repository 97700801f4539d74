"""Finding a cell's files by name: ``BENCHMARK.json`` at the root of the
checkout, and the configuration, traffic, cell and metric files under
``portbench/``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    return json.loads((HERE / kind / f"{check_name(name)}.json").read_text())


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, imported from its file (a name may
    hold dots and dashes, which a package path cannot)."""
    path = HERE / kind / f"{check_name(name)}.py"
    key = f"portbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    settings: dict  # workloads/<cell>.json: trace slice, check limits
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    settings = load_json("workloads", name)
    for key in ("config", "traffic"):
        if settings.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key} {settings.get(key)!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    # Every cell reports every end-to-end metric, and the per-layer metrics
    # whose ``workloads`` name it.
    e2e = bench["end_to_end"]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, config_name=entry["config"],
                config=load_json("configs", entry["config"]),
                traffic_name=entry["traffic"], traffic=load_json("traffic", entry["traffic"]),
                chips=int(entry["chips"]), settings=settings, end_to_end=e2e,
                per_layer=per_layer)
