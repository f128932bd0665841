"""Structured logging + lightweight profiling.

The reference logs with bare ``print`` (``gaussian_process.py:44``,
``policy_transportation.py:47``).  Here: a namespaced stdlib logger, a
metrics recorder that accumulates scalar series (losses, timings,
diagnostics) and dumps JSON, and a wall-clock/`jax.profiler` trace helper
for kernel-level analysis.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

logger = logging.getLogger("gpt_tpu")
if not logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s"))
    logger.addHandler(h)
    logger.setLevel(os.environ.get("GPT_LOGLEVEL", "WARNING"))


def get_logger(name: str = "gpt_tpu") -> logging.Logger:
    return logging.getLogger(name)


class MetricsRecorder:
    def __init__(self):
        self.series: Dict[str, List] = defaultdict(list)

    def record(self, name: str, value, step: Optional[int] = None) -> None:
        self.series[name].append(
            {"step": step if step is not None else len(self.series[name]), "value": float(value)}
        )

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(self.series), f)

    def last(self, name: str):
        return self.series[name][-1]["value"] if self.series[name] else None


@contextlib.contextmanager
def timed(name: str, recorder: Optional[MetricsRecorder] = None):
    """Wall-clock a block; logs (and optionally records) the duration."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    logger.info("%s took %.3fs", name, dt)
    if recorder is not None:
        recorder.record(f"time/{name}", dt)


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace context (view in TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
