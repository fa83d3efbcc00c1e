"""Structured stdout logging + CSV metric sink (no external deps).

The port's own copy of ``repro/util/logging.py``: ``get_logger`` (level
from ``REPRO_LOGLEVEL``) and ``MetricLogger`` with its union-of-keys CSV
rewrite."""

from __future__ import annotations

import csv
import logging
import os
import sys
import time
from typing import Dict, Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("REPRO_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger


class MetricLogger:
    """Accumulates step metrics; optionally mirrors to a CSV file."""

    def __init__(self, csv_path: Optional[str] = None, logger_name: str = "metrics"):
        self.logger = get_logger(logger_name)
        self.csv_path = csv_path
        self._writer = None
        self._file = None
        self._fields: list = []
        self._t0 = time.time()
        self.history = []

    def _reopen(self) -> None:
        """(Re)write the CSV from scratch with the current field union —
        heterogeneous records (e.g. a round that adds eval metrics) used to
        crash DictWriter, whose fieldnames were frozen from the FIRST record."""
        if self._file:
            self._file.close()
        self._file = open(self.csv_path, "w", newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=self._fields,
                                      restval="")
        self._writer.writeheader()
        for past in self.history:
            self._writer.writerow(past)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 3), **metrics}
        self.history.append(rec)
        msg = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in rec.items())
        self.logger.info(msg)
        if self.csv_path:
            new_keys = [k for k in rec if k not in self._fields]
            if new_keys or self._writer is None:
                # union-of-keys header: rewrite history under the new header
                # (records missing a column get ""), then stream as before
                self._fields += new_keys
                self._reopen()
            else:
                self._writer.writerow(rec)
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
            self._writer = None
