"""Scalar metric logging: a JSONL stream and one printed line per record,
with steps/sec between records, as ``sndepth_tpu/utils/logging.py``."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    """Records every logged step; writes ``log_dir/metrics.jsonl`` where
    given, and prints each record when ``echo``."""

    def __init__(self, log_dir: str | None = None, echo: bool = True):
        self._echo = echo
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t_last = time.perf_counter()
        self._step_last = 0
        self.records: list[dict] = []

    def log(self, step: int, metrics: Mapping[str, float]) -> dict:
        now = time.perf_counter()
        record = {k: float(v) for k, v in metrics.items()}
        record["step"] = int(step)
        if step > self._step_last:
            record["steps_per_sec"] = ((step - self._step_last)
                                       / max(now - self._t_last, 1e-9))
        self._t_last = now
        self._step_last = int(step)
        self.records.append(record)
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._echo:
            print(" ".join(f"{k}={v:.5g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in record.items()),
                  flush=True)
        return record

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
