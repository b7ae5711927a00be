"""Small configurations of the benchmark's cells for CPU runs."""
import copy

from benchmarks import harness

#: Frame sizes that a CPU run holds, per configuration.
SMALL = {"cam1080p": (96, 128), "mega8k": (192, 384)}


#: The single-stream cell, whose traffic file is in place but which
#: BENCHMARK.json does not list (PERF.md §7): the tests keep its
#: single-frame route covered.
STREAM = {"name": "cam1080p.stream_calm", "config": "cam1080p", "traffic": "stream_calm",
          "chips": 1, "why": "one live 1080p webcam, a frame a call"}


def suite_with_stream() -> harness.Suite:
    spec = harness.Suite.load().spec
    spec["workloads"].append(dict(STREAM))
    return harness.Suite(spec)


def small_config(cell: harness.Cell, **canny) -> dict:
    cfg = copy.deepcopy(cell.config)
    cfg["canny"]["height"], cfg["canny"]["width"] = SMALL[cfg["name"]]
    cfg["canny"].update(canny)
    return cfg


def small_run(suite: harness.Suite, name: str, seed: int = 2**31 + 9, seconds: float = 0.3,
              **canny) -> dict:
    cell = suite.cell(name)
    return harness.run_cell(suite, name, seed, seconds, False, device="cpu",
                            config=small_config(cell, **canny))
