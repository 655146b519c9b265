"""What a run reads from the repository: ``BENCHMARK.json``, the cell's
configuration file and traffic file, and the metric readers, each found
by the name ``BENCHMARK.json`` gives it."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "ctcbench")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"ctcbench: no workload {name!r} in BENCHMARK.json; "
                     f"there are {[w['name'] for w in bench['workloads']]}")


def config_file(bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return load_json(os.path.join(ROOT, entry["file"]))


def traffic_file(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def port_config(cfg_file: dict):
    """The port's ``Config``: the preset the file names, with every key of
    its ``port`` section set as the file states it (so the file is the
    configuration as it is run)."""
    from tpu_ctc_torch.config import get_config
    overrides = {f"{section}.{key}": value
                 for section, fields in cfg_file["port"].items()
                 for key, value in fields.items()}
    return get_config(cfg_file["preset"], **overrides)


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's metrics: its end-to-end ones with ``--trace 0``, its
    per-layer ones with ``--trace 1``; a metric without ``workloads`` is
    every cell's."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``read(rec, ctx)`` function of ``ctcbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "ctcbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries: List[dict], rec: dict, ctx) -> Dict[str, dict]:
    """Each metric whose reader finds something to read, with its unit;
    the readers that return None are left out."""
    out = {}
    for m in entries:
        value = reader(m["name"])(rec, ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
