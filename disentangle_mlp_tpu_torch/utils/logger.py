"""Per-run JSON logger of the port, a copy of
disentangle_mlp_tpu/utils/logger.py (the port imports nothing of the JAX
package).

Writes one timestamped JSON file per run with the exact schema of the
reference's Logger (reference: utils/logger.py:6-38):

    {"meta_data": {"file": ..., "datetime": ..., "args": {...}},
     "output": [ {...}, {...}, ... ]}

so downstream tooling that parses results/logs/log_*.json keeps working.
Unlike the reference (which re-reads and rewrites the whole file on every
``log()`` call, logger.py:16-21), records are kept in memory and the file is
rewritten atomically — same on-disk format, no quadratic I/O.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from datetime import datetime
from typing import Any, Dict


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


class Logger:
    def __init__(self, log_path: str, settings: Any):
        os.makedirs(log_path, exist_ok=True)
        stamp = datetime.now().strftime("%m_%d_%Y_%H_%M_%S")
        # second-resolution stamps collide when runs start together (e.g.
        # concurrent BO groups logging into one dir). O_CREAT|O_EXCL
        # RESERVES the name atomically — a check-then-act exists() loop
        # would still let two same-second processes pick the same file.
        n = 0
        while True:
            suffix = "" if n == 0 else f"_{n}"
            self.log_file = os.path.join(log_path,
                                         f"log_{stamp}{suffix}.json")
            try:
                os.close(os.open(self.log_file,
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                break
            except FileExistsError:
                n += 1

        if dataclasses.is_dataclass(settings) and not isinstance(settings, type):
            args: Any = {k: _jsonable(v) for k, v in dataclasses.asdict(settings).items()}
        else:
            try:
                args = {k: _jsonable(v) for k, v in vars(settings).items()}
            except TypeError:
                warnings.warn("No __dict__ found in Object")
                args = []

        self._data: Dict[str, Any] = {
            "meta_data": {
                "file": os.path.basename(__file__),
                "datetime": str(datetime.now()),
                "args": args,
            },
            "output": [],
        }
        self._flush()

    def _flush(self) -> None:
        d = os.path.dirname(self.log_file) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f, indent=4)
            os.replace(tmp, self.log_file)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def log(self, results: Dict[str, Any]) -> None:
        self._data["output"].append({k: _jsonable(v) for k, v in results.items()})
        self._flush()
