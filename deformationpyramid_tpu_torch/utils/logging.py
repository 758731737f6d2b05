"""Append-to-file logger, running-average meters and run provenance.

Counterpart of ``deformationpyramid_tpu/utils/logging.py`` (reference
``utils/utils.py:2-33``); ``AverageMeter`` and ``Logger`` are copies.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.sq_sum = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += float(val) ** 2 * n

    @property
    def std(self) -> float:
        if self.count == 0:
            return 0.0
        var = self.sq_sum / self.count - self.avg ** 2
        return max(var, 0.0) ** 0.5


class Logger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.fw = open(path, "a")

    def write(self, text: str):
        self.fw.write(text)
        self.fw.flush()

    def close(self):
        self.fw.close()


def write_run_provenance(snap_dir: str, config_path: str | None = None,
                         device: str | None = None):
    """Record what produced a snapshot dir: a ``provenance.json`` with the
    git revision, the command line, the torch version and the device, and
    a copy of the config file (the reference copies its whole source tree
    into the experiment dir instead, ``eval_nolearned.py:44-47``)."""
    import torch

    info = {"argv": sys.argv, "time": time.strftime("%Y-%m-%d %H:%M:%S"),
            "torch": torch.__version__, "device": device}
    try:
        info["git_rev"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except Exception:
        info["git_rev"] = "unknown"
    os.makedirs(snap_dir, exist_ok=True)
    with open(os.path.join(snap_dir, "provenance.json"), "w") as f:
        json.dump(info, f, indent=1)
    if config_path and os.path.isfile(config_path):
        shutil.copy(config_path, os.path.join(
            snap_dir, os.path.basename(config_path)))
