"""Running-average meter.

A copy of ``AverageMeter`` from ``deformationpyramid_tpu/utils/logging.py``
(reference ``utils/utils.py:2-33``).
"""
from __future__ import annotations


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
