"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration
(``configs/<file>`` of that entry), its traffic (``traffic/<name>.json``)
and, by its own name, its limits (``limits/<workload>.json``: the numbers
that decide ``correct``, each with its limit). The configuration names its
plain reference (``"reference": "<module>"``, ``reference/<module>.py``),
the only code that knows its architecture. Per-layer metrics are readers
in ``metrics/<name>.py``. A cell reports the end-to-end metrics
that list it (or list no cells) and the per-layer metrics that list it
(or, listing no cells, move a metric the cell reports).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# What a reference module gives (reference/__init__.py).
INTERFACE = ("Generator", "text_inputs", "example_text", "fix_weights",
             "TEXT_PREFIXES", "F32_MODULES", "counted")


class ManifestError(ValueError):
    """BENCHMARK.json or a file it names does not describe a cell."""


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(ROOT / "BENCHMARK.json")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    def __init__(self, name: str, spec: dict = None):
        bench = spec or benchmark()
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise ManifestError(f"no workload {name!r} in BENCHMARK.json "
                                f"(have: {sorted(entries)})")
        self.name = name
        self.workload = entries[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _load(ROOT / configs[self.workload["config"]]["file"])
        self.reference = reference_module(self.config)
        self.traffic = _load(BENCH_DIR / "traffic"
                             / f"{self.workload['traffic']}.json")
        self.limits = _load(BENCH_DIR / "limits" / f"{name}.json")
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _reports(m, name)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]


def reference_module(cfg: dict) -> ModuleType:
    """The plain reference that ``cfg`` names: ``reference/<module>.py``."""
    name = cfg.get("reference")
    if not isinstance(name, str) or \
            not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ManifestError(
            f"configuration {cfg.get('name')!r} names no reference module: "
            f"it needs \"reference\": \"<module>\" for "
            f"portbench/reference/<module>.py (found {name!r})")
    if not (BENCH_DIR / "reference" / f"{name}.py").is_file():
        raise ManifestError(
            f"configuration {cfg.get('name')!r} names reference module "
            f"{name!r}, but there is no portbench/reference/{name}.py")
    module = importlib.import_module(f"reference.{name}")
    missing = [k for k in INTERFACE if not hasattr(module, k)]
    if missing:
        raise ManifestError(f"reference/{name}.py lacks {missing}")
    return module


def metric_reader(name: str) -> Callable:
    """``read(run) -> float or None`` of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(cfg: dict):
    """The program's ``VariantConfig`` holding every field of the file."""
    import dataclasses

    from vae_gan_mark_tpu_torch.config import SchedulerConfig, get_config
    base = get_config(cfg["variant"])
    fields = {f.name for f in dataclasses.fields(base)}
    values: Dict = {k: v for k, v in cfg.items()
                    if k in fields and k != "name"}
    values["enc_chans"] = tuple(values["enc_chans"])
    if isinstance(values.get("scheduler"), dict):
        values["scheduler"] = SchedulerConfig(**values["scheduler"])
    port = get_config(cfg["variant"], **values)
    if port.name != cfg["name"]:
        raise ValueError(f"config {cfg['name']!r} is variant {port.name!r}")
    return port
