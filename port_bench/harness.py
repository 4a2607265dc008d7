"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the recorder of kernel calls behind the rooflines,
the comparison that decides ``correct``, the metrics of the result line,
and the rule that no JAX module is loaded.

A cell is a workload of ``BENCHMARK.json``: its configuration is
``configs/<config>.json`` with the program's model ``models/<config>.py``
(built from the port's public layers and entry points), the plain
reference ``reference/<config>.py`` and the FLOP count
``flops/<config>.py``; its traffic is ``traffic/mixes/<traffic>.json``,
whose ``kind`` names the driver ``traffic/<kind>.py``; its correctness
limits are
``limits/<workload>.json``; a per-layer metric is ``metrics/<name>.py``
and a kernel wrapper's bound ``bounds/<wrapper>.py``.
"""
from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

import work

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# the program under test is the checkout's rec_now_tpu_torch
if str(REPO) not in sys.path:
    sys.path.insert(1, str(REPO))
# top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rec_now_tpu")


def load_path(path: Path, name: str):
    """The module at ``path`` under the name ``name`` (loaded once)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return read_json(REPO / "BENCHMARK.json")


def reference(config: str):
    """``reference/<config>.py``; its shared pieces import as ``plain``."""
    plain()
    return load_path(ROOT / "reference" / f"{config}.py",
                     "port_bench_ref_" + config.replace("-", "_"))


def plain():
    reference_dir = str(ROOT / "reference")
    if reference_dir not in sys.path:
        sys.path.insert(0, reference_dir)
    return importlib.import_module("plain")


def flops(config: str):
    return load_path(ROOT / "flops" / f"{config}.py",
                     "port_bench_flops_" + config.replace("-", "_"))


def program(config: str):
    """``models/<config>.py``: ``feature_config(cfg)`` and ``build(cfg,
    device)``, the program's side of a configuration."""
    return load_path(ROOT / "models" / f"{config}.py",
                     "port_bench_model_" + config.replace("-", "_"))


class Cell:
    """One workload's files and the run's arguments."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, bench: Optional[dict] = None,
                 log=None, sizes: Optional[dict] = None):
        """``sizes`` overrides keys of the configuration and the mix (a
        test's small shapes; ``{"cfg": {...}, "mix": {...}}``)."""
        for sub in ("traffic", "reference"):
            if str(ROOT / sub) not in sys.path:
                sys.path.insert(0, str(ROOT / sub))
        bench = benchmark() if bench is None else bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.bench = bench
        self.workload = found[0]
        self.name = name
        self.config_name = self.workload["config"]
        self.cfg = read_json(ROOT / "configs" / f"{self.config_name}.json")
        self.mix = read_json(ROOT / "traffic" / "mixes"
                             / f"{self.workload['traffic']}.json")
        self.limits = read_json(ROOT / "limits" / f"{name}.json")
        if sizes:
            self.cfg.update(sizes.get("cfg", {}))
            self.mix.update(sizes.get("mix", {}))
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.reference = reference(self.config_name)
        self.plain = plain()
        self.flops = flops(self.config_name)
        self.program = program(self.config_name)
        self.log = log or (lambda msg: print(msg, file=sys.stderr,
                                             flush=True))
        self._marks = [("start", t_start)]

    def mark(self, phase: str) -> None:
        """End a set-up phase (logged by :meth:`log_phases`)."""
        import time
        self._marks.append((phase, time.monotonic()))

    def log_phases(self) -> None:
        self.log("set-up phases (s): " + ", ".join(
            f"{name} {t - prev:.2f}" for (_, prev), (name, t)
            in zip(self._marks, self._marks[1:])))

    def driver(self):
        return load_path(ROOT / "traffic" / f"{self.mix['kind']}.py",
                         "port_bench_traffic_" + self.mix["kind"])


def per_second(ends: List[float], t0: float) -> List[int]:
    """Pieces of work ended in each whole second after ``t0``, from the
    times they ended: the window's steadiness, for the log."""
    out: List[int] = []
    for t in ends:
        k = int(t - t0)
        out += [0] * (k + 1 - len(out))
        out[k] += 1
    return out[:-1] if len(out) > 1 else out


# -- kernel calls behind the rooflines ---------------------------------------
class CallRecorder:
    """While entered, every call of a wrapper that has a file in
    ``bounds/`` is recorded (its ``record`` summary) on its way to the
    wrapper: each module of the program that holds the wrapper's function
    gets a recording stand-in, and the original comes back on exit, with
    the launch count the stand-in kept."""

    def __init__(self):
        self.mods = {p.stem: load_path(p, "port_bench_bound_" + p.stem)
                     for p in sorted((ROOT / "bounds").glob("*.py"))}
        self.calls: List[tuple] = []
        self._patches: List[tuple] = []

    def __enter__(self):
        for wrapper, mod in self.mods.items():
            home_name, attr = mod.TARGET.split(":")
            home = importlib.import_module(home_name)
            orig = getattr(home, attr)
            stand_in = self._stand_in(wrapper, mod, orig)
            for m in list(sys.modules.values()):
                if not getattr(m, "__name__", "").startswith(
                        "rec_now_tpu_torch"):
                    continue
                for k, v in list(vars(m).items()):
                    if v is orig:
                        setattr(m, k, stand_in)
                        self._patches.append((m, k, orig, stand_in))
        return self

    def _stand_in(self, wrapper, mod, orig):
        calls = self.calls

        @functools.wraps(orig)
        def recorded(*args, **kwargs):
            calls.append((wrapper, mod.record(args, kwargs)))
            return orig(*args, **kwargs)
        return recorded

    def __exit__(self, *exc):
        for m, k, orig, stand_in in reversed(self._patches):
            setattr(m, k, orig)
            if hasattr(stand_in, "launches"):
                orig.launches = stand_in.launches
        self._patches.clear()
        return False

    def bound_s(self) -> Dict[str, float]:
        """Least seconds of the recorded calls, summed by wrapper."""
        out: Dict[str, float] = {}
        for wrapper, rec in self.calls:
            ops, nbytes = self.mods[wrapper].work(rec)
            out[wrapper] = out.get(wrapper, 0.0) + work.bound_s(ops, nbytes)
        return out


# -- correctness -------------------------------------------------------------
def serve_checks(prog: List, ref: List) -> Dict[str, float]:
    """``logit_gap``: over the requests compared, the largest
    max|program - reference| / max|reference| of a request's logits."""
    gap = 0.0
    for p, r in zip(prog, ref):
        gap = max(gap, float(abs(p - r).max()) / max(float(abs(r).max()),
                                                     1e-30))
    return {"logit_gap": gap}


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(all within their limits and finite, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in values.items())
    return ok, checks


# -- the result line ---------------------------------------------------------
def _assigned(metric: dict, workload: dict, reported: set) -> bool:
    if "workloads" in metric:
        return workload["name"] in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def end_to_end(bench: dict, workload: dict, values: Dict[str, float]):
    out = {}
    for m in bench["end_to_end"]:
        if "workloads" in m and workload["name"] not in m["workloads"]:
            continue
        if m["name"] not in values:
            raise RuntimeError(f"{workload['name']} measured no {m['name']}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(bench: dict, workload: dict, ctx: dict):
    reported = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m
                or workload["name"] in m["workloads"]}
    out = {}
    for m in bench["per_layer"]:
        if not _assigned(m, workload, reported):
            continue
        reader = metric_reader(m["name"])
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def metric_reader(name: str):
    """``metrics/<name>.py``, or for ``<base>.<suffix>`` without a file of
    its own (the same quantity split by the end-to-end metric it moves)
    ``metrics/<base>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists():
        path = ROOT / "metrics" / f"{name.split('.', 1)[0]}.py"
    return load_path(path, "port_bench_metric_" + path.stem.replace(".", "_"))


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({n for n in sys.modules
                   if n.split(".", 1)[0] in FORBIDDEN})
