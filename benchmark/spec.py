"""Finds a workload's pieces by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its cell parameters (``cells/<workload>.json``),
the generator the mix names (``generators/<generator>.py``) and one reader
per metric (``metrics/<metric>.py``, or one a quantity: :func:`reader`).
Adding any of them adds a file and edits none."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


class SpecError(ValueError):
    pass


@dataclasses.dataclass
class Workload:
    name: str
    chips: int
    cfg: dict
    mix: dict
    cell: dict
    end_to_end: list
    per_layer: list
    benchmark: dict


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path.relative_to(REPO)}")
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, benchmark_file: pathlib.Path = REPO / "BENCHMARK.json") -> Workload:
    bench = _json(benchmark_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(known: {', '.join(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(REPO / configs[w["config"]]["file"])
    return Workload(
        name=workload, chips=int(w["chips"]), cfg=cfg,
        mix=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        cell=_json(HERE / "cells" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        benchmark=bench)


def generator(name: str):
    """The traffic kind a mix names: ``generators/<name>.py``."""
    return importlib.import_module(f"benchmark.generators.{name}")


def reader(metric: str):
    """The per-layer metric's reader: ``metrics/<metric>.py``, or where no
    file has the full name, ``metrics/<name before the first dot>.py``, so
    that one reader serves a quantity under every suffix (``.open``,
    ``.bulk``).  Metric names carry dots, so the file is loaded by path."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    if not path.is_file():
        raise SpecError(f"no reader metrics/{metric}.py or {path.relative_to(REPO)}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
