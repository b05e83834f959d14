"""BENCHMARK.json and the files it names: a cell's configuration, its traffic
(`oclbench/traffic/<traffic>.json`), its correctness limits
(`oclbench/limits/<workload>.json`) and its per-layer readers
(`oclbench/metrics/<metric>.py`). A later cell or metric is files and
entries; nothing here changes for it. `problems` lists what breaks the
benchmark's rules on names, units and sizes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Cell:
    """One workload of the benchmark, with what the harness reads for it."""

    @classmethod
    def of(cls, name, config, traffic, limits, end_to_end=(), per_layer=(), chips=1):
        """A cell from its parts (the tests' small cells)."""
        cell = cls.__new__(cls)
        cell.name, cell.config, cell.traffic, cell.limits = name, config, traffic, limits
        cell.entry = {"name": name, "chips": chips}
        cell.end_to_end, cell.per_layer = list(end_to_end), list(per_layer)
        return cell

    def __init__(self, root: Path, bench: dict, workload: str):
        root = Path(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError("no workload {!r} in BENCHMARK.json; it has {}".format(
                workload, ", ".join(sorted(cells))))
        self.entry = cells[workload]
        self.name = workload
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = read_json(root / conf["file"])
        self.traffic = read_json(HERE / "traffic" / (self.entry["traffic"] + ".json"))
        self.limits = read_json(HERE / "limits" / (workload + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload]) and m["moves"] in moves]


def reader(metric: str):
    """The `read(run)` function of a per-layer metric's file."""
    path = HERE / "metrics" / (metric + ".py")
    spec = importlib.util.spec_from_file_location("oclbench_metric_" + re.sub(r"\W", "_", metric),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def problems(bench: dict, root: Path) -> list:
    """What in `bench` breaks the benchmark's rules, as sentences."""
    out = []
    root = Path(root)
    want = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(bench) != want:
        out.append("keys {} differ from {}".format(sorted(bench), sorted(want)))
    names = []
    for c in bench.get("configs", []):
        names.append(("config", c.get("name")))
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append("config {} has keys {}".format(c.get("name"), sorted(c)))
        if not (root / c.get("file", "")).is_file():
            out.append("config file {} is missing".format(c.get("file")))
        if not any(c.get("file", "").startswith(p + "/") for p in bench.get("paths", [])):
            out.append("config file {} lies outside paths".format(c.get("file")))
        for k in c.get("reduced", []):
            names.append(("reduced key", k))
        if not (_line(c.get("why")) and _line(c.get("source"))):
            out.append("config {}: why or source is not one line of 1-200".format(c.get("name")))
    pairs = set()
    for w in bench.get("workloads", []):
        names += [("workload", w.get("name")), ("config", w.get("config")),
                  ("traffic", w.get("traffic"))]
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append("workload {} has keys {}".format(w.get("name"), sorted(w)))
        if w.get("chips") not in (1, 4):
            out.append("workload {} asks for {} chips".format(w.get("name"), w.get("chips")))
        if (w.get("config"), w.get("traffic")) in pairs:
            out.append("workload {} repeats a configuration and traffic".format(w.get("name")))
        pairs.add((w.get("config"), w.get("traffic")))
        if not _line(w.get("why")):
            out.append("workload {}: why is not one line of 1-200".format(w.get("name")))
    cells = {w.get("name") for w in bench.get("workloads", [])}
    e2e = {}
    for m in bench.get("end_to_end", []) + bench.get("per_layer", []):
        names.append(("metric", m.get("name")))
        if not (isinstance(m.get("unit"), str) and UNIT.match(m["unit"])):
            out.append("metric {} has unit {!r}".format(m.get("name"), m.get("unit")))
        if m.get("better") not in ("lower", "higher"):
            out.append("metric {}: better is {!r}".format(m.get("name"), m.get("better")))
        if not set(m.get("workloads", [])) <= cells:
            out.append("metric {} names unknown workloads".format(m.get("name")))
    for m in bench.get("end_to_end", []):
        e2e[m.get("name")] = m
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append("end-to-end metric {} has source {}".format(m.get("name"), m.get("source")))
        if not 0.01 <= m.get("bound", 0) <= 0.25:
            out.append("end-to-end metric {} has bound {}".format(m.get("name"), m.get("bound")))
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench.get("per_layer", []):
        if m.get("source") not in SOURCES or m.get("moves") not in e2e or not _line(m.get("layer")):
            out.append("per-layer metric {} has a bad source, moves or layer".format(m.get("name")))
        if not (HERE / "metrics" / (m.get("name", "") + ".py")).is_file():
            out.append("per-layer metric {} has no reader".format(m.get("name")))
    for kind, n in names:
        if not (isinstance(n, str) and NAME.match(n)):
            out.append("{} name {!r} breaks the name rule".format(kind, n))
    for kind in ("config", "workload", "metric"):
        pool = [n for k, n in names if k == kind]
        if kind == "config":
            pool = [c.get("name") for c in bench.get("configs", [])]
        if len(pool) != len(set(pool)):
            out.append("two {}s share a name".format(kind))
    if not 1 <= bench.get("run_seconds", 0) <= 51:
        out.append("run_seconds {} is outside 1-51".format(bench.get("run_seconds")))
    return out
