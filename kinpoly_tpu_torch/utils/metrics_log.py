"""Training metrics stream (port of ``kinpoly_tpu/utils/metrics_log.py``).

Scalars go to a JSONL stream, ``<out_dir>/<run_name>_metrics.jsonl``, one
line ``{"step", "time", ...flat scalars}`` per call (always), and to
TensorBoard event files under ``<out_dir>/tb/<run_name>`` when
``torch.utils.tensorboard`` imports. wandb is not ported.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str = "run"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}_metrics.jsonl")
        self._jsonl = open(self.path, "a", buffering=1)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(os.path.join(out_dir, "tb", run_name))

    def log(self, step: int, scalars: dict, prefix: str = "") -> None:
        """Write the scalars of `scalars` (a sequence value becomes
        ``key/i`` entries; values that are not numbers are skipped)."""
        flat = {}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            try:
                if hasattr(v, "__len__") and not isinstance(v, str):
                    for i, vi in enumerate(v):
                        flat[f"{key}/{i}"] = float(vi)
                else:
                    flat[key] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(dict(step=step, time=time.time(), **flat))
                          + "\n")
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
