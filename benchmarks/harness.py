"""The benchmark's harness: one cell, one seed, one run.

Everything is found by name from ``BENCHMARK.json``: a cell's
configuration is the JSON file its entry names (``configs/``), its traffic
``traffic/<traffic>.json`` (read by :mod:`benchmarks.scenes`), each
per-layer metric ``metrics/<metric>.py`` (a reader: ``read(readings)`` ->
a number, or None when there is nothing to read). A new cell, mix or
metric is a new file and a new entry; no code here names one.

A run:

1. set-up: the engine, the cell's inputs made on the device from the seed,
   and a warm-up of every call input of the cell (every shape and every
   content the window will see), with the outputs kept for the check held
   as the window will hold them;
2. the window: a closed loop of calls for ``seconds``, at most
   ``in_flight`` calls issued and not yet waited for; a CUDA event before
   each call's first launch and after its last, each call's time read once
   it is retired; the host's enqueue time of each call; the kernels'
   launch counter over the window;
3. with ``trace``: a traced stretch of the same loop after the window,
   under ``torch.profiler``, opened by sentinels and used only when whole;
4. the peak of device memory, then the program freed, then the check: the
   outputs of a sample of the window's calls, drawn from the seed, against
   the plain reference (``reference/``) on the same inputs.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
import sys
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmarks import devtrace, scenes
from benchmarks.reference import canny as reference

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cudacam_tpu")
#: The traced stretch: at most this many calls, or this many seconds.
TRACE_CALLS = 1000
TRACE_SECONDS = 2.0


# --- the suite: cells, configurations, traffic, readers, by name -------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: scenes.Traffic
    end_to_end: List[dict]
    per_layer: List[dict]


class Suite:
    """``BENCHMARK.json`` and the files it names. ``bench_dir`` holds
    ``traffic/`` and ``metrics/``; configuration files are named by path
    from ``root``."""

    def __init__(self, spec: dict, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> None:
        self.spec, self.root, self.bench_dir = spec, Path(root), Path(bench_dir)

    @classmethod
    def load(cls, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> "Suite":
        return cls(json.loads((Path(root) / "BENCHMARK.json").read_text()), root, bench_dir)

    def cell(self, name: str) -> Cell:
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        w = work[name]
        (conf,) = [c for c in self.spec["configs"] if c["name"] == w["config"]]
        config = json.loads((self.root / conf["file"]).read_text())
        traffic = scenes.Traffic.from_dict(
            json.loads((self.bench_dir / "traffic" / f"{w['traffic']}.json").read_text()))

        def mine(metrics):
            return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

        return Cell(name, w["chips"], config, traffic, mine(self.spec["end_to_end"]),
                    mine(self.spec["per_layer"]))

    def reader(self, metric: str) -> Callable[["Readings"], Optional[float]]:
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


# --- the program: built from a configuration file -----------------------------

def make_program(config: dict, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """``call(input) -> edge maps`` through the configuration's entry point
    (``CannyEngine.process`` or ``ShardedCannyEngine.process`` to HYSTER)."""
    from cudacam_tpu_torch import CannyConfig, CannyStage

    cfg = CannyConfig(**config["canny"])
    if config["engine"] == "CannyEngine":
        from cudacam_tpu_torch.engine.engine import CannyEngine

        eng = CannyEngine(cfg, device=device)
        return lambda x: eng.process(x, CannyStage.HYSTER)
    if config["engine"] == "ShardedCannyEngine":
        from cudacam_tpu_torch.engine.sharded_engine import ShardedCannyEngine
        from cudacam_tpu_torch.parallel.mesh import make_mesh

        eng = ShardedCannyEngine(cfg, make_mesh(**config["mesh"]), device=device)
        return lambda x: eng.process(x, CannyStage.HYSTER)
    raise ValueError(f"unknown engine {config['engine']!r}")


def launch_counts() -> Dict[str, int]:
    from cudacam_tpu_torch.ops.cuda import launch_counts as counts

    return dict(counts())


# --- clocks -------------------------------------------------------------------

class _HostEvent:
    """A CUDA event's surface on the host clock (CPU runs of the tests)."""

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


def _event(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def _stream(device: torch.device):
    """The stream the program launches on: events are recorded on it by
    handle, which spares each record a lookup of the current stream."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- the closed loop ----------------------------------------------------------

class Loop:
    """A closed loop of calls over a run's inputs: a call is issued once
    fewer than ``in_flight`` calls are outstanding; each call's time on the
    stream is read once the call is retired."""

    def __init__(self, call, inputs: scenes.Inputs, in_flight: int, device,
                 keep: Callable[[int], Optional[int]]) -> None:
        self.call, self.inputs, self.in_flight, self.device = call, inputs, in_flight, device
        self.keep = keep
        self.pending: deque = deque()
        self.free = [(_event(device), _event(device)) for _ in range(in_flight + 1)]
        self.stream = _stream(device)
        self.i = 0
        self.times_ms: List[float] = []
        self.host_us: List[float] = []
        self.kept: Dict[int, tuple] = {}
        self.spans = False

    def _retire(self) -> None:
        s, e = self.pending.popleft()
        if self.spans:
            with torch.profiler.record_function(devtrace.WAIT_SPAN):
                e.synchronize()
        else:
            e.synchronize()
        self.times_ms.append(s.elapsed_time(e))
        self.free.append((s, e))

    def run(self, deadline: float, max_calls: Optional[int] = None) -> None:
        """Issue calls until the host clock passes ``deadline`` (or
        ``max_calls`` calls)."""
        order, calls, n = self.inputs.order, self.inputs.calls, len(self.inputs.order)
        stream = self.stream
        clock, stop = time.perf_counter, self.i + (max_calls if max_calls is not None else 1 << 62)
        while self.i < stop and clock() < deadline:
            if len(self.pending) >= self.in_flight:
                self._retire()
            s, e = self.free.pop()
            c = order[self.i % n]
            s.record(stream)
            h0 = clock()
            if self.spans:
                with torch.profiler.record_function(devtrace.CALL_SPAN):
                    out = self.call(calls[c])
            else:
                out = self.call(calls[c])
            h1 = clock()
            e.record(stream)
            self.host_us.append((h1 - h0) * 1e6)
            self.pending.append((s, e))
            slot = self.keep(self.i)
            if slot is not None:
                self.kept[slot] = (c, out)
            self.i += 1

    def drain(self) -> None:
        _sync(self.device)
        while self.pending:
            self._retire()


# --- statistics ---------------------------------------------------------------

def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile of all ``values``, linear between the two
    nearest ranks (NumPy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# --- what readers see ---------------------------------------------------------

@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the window's counts and host times,
    and the traced stretch's device lane (None when no session was whole)."""

    cell: str
    canny: dict  # the configuration's CannyConfig fields
    frames: int  # frames completed in the window
    launches: Dict[str, int]  # kernel launches in the window, by kernel
    host_us: List[float]  # each window call's enqueue time on the host
    lane: Optional[devtrace.Lane]


# --- the check ----------------------------------------------------------------

def check(config: dict, inputs: scenes.Inputs, kept: Dict[int, tuple],
          chain_dtype: Optional[torch.dtype] = None) -> Dict[str, int]:
    """Compare each kept call's edge maps with the reference on the same
    source frames: mismatched pixels, frames compared and frames the
    reference cut off at the round cap. With ``chain_dtype`` the control
    (the reference in that precision) takes the program's place."""
    canny = config["canny"]
    refs: Dict[int, torch.Tensor] = {}
    control: Dict[int, torch.Tensor] = {}
    out = {"mismatched_px": 0, "frames_compared": 0, "frames_mismatched": 0,
           "frames_cut_by_cap": 0}
    for c, result in kept.values():
        maps = result if result.ndim == 3 else result.unsqueeze(0)
        for slot, src in enumerate(inputs.slots[c]):
            if src not in refs:
                refs[src], _, cut = reference.canny(inputs.sources[src], canny)
                out["frames_cut_by_cap"] += int(cut)
            got = maps[slot]
            if chain_dtype is not None:
                if src not in control:
                    control[src] = reference.canny(inputs.sources[src], canny, chain_dtype)[0]
                got = control[src]
            bad = int((got != refs[src]).sum())
            out["mismatched_px"] += bad
            out["frames_mismatched"] += int(bad > 0)
            out["frames_compared"] += 1
    return out


#: Each number the check compares: (limit, "at most" or "at least").
LIMITS = {"mismatched_px": (0, "at most"), "frames_compared": (1, "at least")}


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= v if rule == "at most" else numbers[k] >= v
               for k, (v, rule) in LIMITS.items())


def check_lines(numbers: Dict[str, int]) -> Dict[str, dict]:
    """The compared numbers with their limits, as the result line's last
    key and the run's last lines on standard error."""
    return {k: {"value": numbers[k], "limit": v, "rule": rule} for k, (v, rule) in LIMITS.items()}


# --- one run ------------------------------------------------------------------

def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_cell(suite: Suite, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             config: Optional[dict] = None) -> dict:
    """One run of cell ``name``; the result line's keys (without the
    forbidden-module look, which the caller makes once the run is over).
    ``t_start``: the process's start on the host clock (set-up is counted
    from it). ``config`` replaces the cell's configuration (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cell = suite.cell(name)
    config = config or cell.config
    traffic = cell.traffic
    call = make_program(config, device)
    inputs = scenes.make_inputs(traffic, config["canny"]["height"], config["canny"]["width"],
                                seed, device)
    rng = random.Random(seed ^ 0x5EED)

    # Warm-up: every call input, then the check's outputs held as the
    # window holds them, so that no first launch or allocation falls
    # inside the window.
    warm = Loop(call, inputs, traffic.in_flight, device,
                scenes.reservoir(random.Random(seed), traffic.check_calls))
    warm.run(math.inf, max_calls=len(inputs.order) + traffic.check_calls + traffic.in_flight)
    warm.drain()
    del warm
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    loop = Loop(call, inputs, traffic.in_flight, device,
                scenes.reservoir(rng, traffic.check_calls))
    before = launch_counts()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    loop.run(t0 + seconds)
    loop.drain()
    window_s = time.perf_counter() - t0
    after = launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}
    window_calls, window_times, window_host = loop.i, list(loop.times_ms), list(loop.host_us)
    frames = window_calls * inputs.frames_per_call

    lane, why = None, "not traced"
    if trace:
        lane, why = trace_stretch(loop, device, inputs.frames_per_call)

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kept = dict(loop.kept)
    del loop, call
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check(config, inputs, kept)
    check_s = time.perf_counter() - t_check
    correct = verdict(numbers)

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": device_name(device), "count": cell.chips,
                   "memory_peak_bytes": memory_peak}
    if not trace:
        values = {"setup_s": setup_s, "frames_per_s": frames / window_s,
                  "call_p95_ms": percentile(window_times, 95)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None
    else:
        readings = Readings(name, config["canny"], frames, launches, window_host, lane)
        metrics = {}
        for m in cell.per_layer:
            v = suite.reader(m["name"])(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = None
        if lane is not None:
            device_info["busy_s"] = lane.busy_us() / 1e6
            device_info["window_s"] = lane.window_us / 1e6
            breakdown = {"device_ops": lane.top_ops(), "idle_gaps": lane.top_gaps()}
    result = {"correct": correct, "attempted": frames,
              "failed": numbers["frames_mismatched"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["run"] = {"seed": seed, "calls": window_calls, "window_s": window_s,
                     "frames_per_call": inputs.frames_per_call, "trace": why or "whole",
                     "frames_cut_by_cap": numbers["frames_cut_by_cap"],
                     "call_p50_ms": percentile(window_times, 50),
                     "call_min_ms": min(window_times), "call_max_ms": max(window_times),
                     "host_us_mean": sum(window_host) / len(window_host), "check_s": check_s}
    result["checks"] = check_lines(numbers)
    return result


def trace_stretch(loop: Loop, device, frames_per_call: int):
    """A traced stretch of the loop after the window: up to three sessions,
    each opened by more sentinels, the first whole one kept. (lane, why)."""
    if device.type != "cuda":
        return None, "no device lane on the CPU"
    from torch.profiler import ProfilerActivity, profile

    why = ""
    for sentinels in devtrace.SENTINELS:
        loop.drain()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            devtrace.open_session(device, sentinels)
            c0 = loop.i
            loop.spans = True
            with torch.profiler.record_function(devtrace.STRETCH_SPAN):
                loop.run(time.perf_counter() + TRACE_SECONDS, max_calls=TRACE_CALLS)
                loop.drain()
            loop.spans = False
        calls = loop.i - c0
        lane, why = devtrace.read_lane(prof.events(), calls, calls * frames_per_call)
        if lane is not None:
            return lane, ""
        print(f"trace: session with {sentinels} sentinels not whole: {why}", file=sys.stderr)
    return None, why


def forbidden_modules() -> List[str]:
    """Modules of the forbidden top-level names loaded in this process."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))
