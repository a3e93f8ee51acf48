"""Where the port's CPU tests spend their time.

As a pytest plugin, it splits each test module's wall time into the JAX
package's compiles (``jax.monitoring``'s trace, lowering and backend
compile durations), the JAX systems' runs and the port's runs (the
outermost ``process_frame`` / ``process_frames`` / ``flush`` /
``get_trajectory`` calls of each package's system classes), and appends
one JSON line a module to ``$TEST_COST_OUT`` (default ``test_cost.jsonl``):

    PYTHONPATH=scripts TEST_COST_OUT=cost.jsonl python -m pytest -p test_cost \\
        -p xdist -n 6 --dist loadfile --junitxml=run.xml tests/test_torch_pipelined.py ...

As a script, it sums the test time of each module in junit files (one
column a file) and prints the two files' difference:

    python scripts/test_cost.py parent.xml change.xml
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import xml.etree.ElementTree as ET

STATS = collections.defaultdict(collections.Counter)
_current = {"module": None}
_depth = threading.local()


def _listen() -> None:
    import jax.monitoring

    def on_event(event, secs, **kw):
        if _current["module"] is not None and any(w in event for w in ("compile", "trace", "mlir")):
            STATS[_current["module"]]["jax_compile_s"] += secs

    jax.monitoring.register_event_duration_secs_listener(on_event)


def _time_systems(package: str, tag: str) -> None:
    """Time the outermost calls of each system class's entry points."""
    import importlib
    import inspect
    import pkgutil

    models = importlib.import_module(f"{package}.models")
    for info in pkgutil.iter_modules(models.__path__):
        mod = importlib.import_module(f"{package}.models.{info.name}")
        for cls in vars(mod).values():
            if not inspect.isclass(cls) or cls.__module__ != mod.__name__:
                continue
            for meth in ("process_frame", "process_frames", "flush", "get_trajectory"):
                fn = cls.__dict__.get(meth)
                if fn is not None:
                    setattr(cls, meth, _timed(fn, tag))


def _timed(fn, tag: str):
    def wrapped(*a, **kw):
        depth = getattr(_depth, tag, 0)
        setattr(_depth, tag, depth + 1)
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            setattr(_depth, tag, depth)
            if depth == 0 and _current["module"] is not None:
                STATS[_current["module"]][tag] += time.perf_counter() - t0

    return wrapped


def pytest_configure(config):
    _listen()
    _time_systems("orb_slam3_ros_tpu", "jax_run_s")
    _time_systems("orb_slam3_ros_tpu_torch", "port_run_s")


def pytest_runtest_protocol(item, nextitem):
    _current["module"] = item.module.__name__


def pytest_runtest_logreport(report):
    if _current["module"] is not None:
        STATS[_current["module"]]["test_s"] += report.duration


def pytest_unconfigure(config):
    with open(os.environ.get("TEST_COST_OUT", "test_cost.jsonl"), "a") as f:
        for module, c in STATS.items():
            f.write(json.dumps({"module": module, **{k: round(v, 2) for k, v in c.items()}}) + "\n")


def junit_seconds(path: str) -> collections.Counter:
    """Summed test time of each module in a junit file."""
    out = collections.Counter()
    for case in ET.parse(path).iter("testcase"):
        out[case.get("classname").split(".")[-1]] += float(case.get("time"))
    return out


def main(argv: list[str]) -> int:
    runs = [junit_seconds(p) for p in argv]
    for module in sorted(set().union(*runs)):
        row = [r.get(module, 0.0) for r in runs]
        diff = f" {row[-1] - row[0]:+9.1f}" if len(row) > 1 else ""
        print(f"{module:40s}" + "".join(f" {x:9.1f}" for x in row) + diff)
    print(f"{'total':40s}" + "".join(f" {sum(r.values()):9.1f}" for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
