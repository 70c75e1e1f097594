"""Plain Adam (Kingma and Ba, 2015), the update the benchmark's reference
takes after each reference gradient: ``m ← b1·m + (1 − b1)·g``,
``v ← b2·v + (1 − b2)·g²``, ``p ← p − (lr / (1 − b1^t))·m / (√v / √(1 − b2^t)
+ eps)``, with ``eps`` outside the square root."""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params, grads, frozen=()):
        """``params`` after one update; leaves in ``frozen`` keep their
        value."""
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.m[k] * self.b1 + g * (1.0 - self.b1)
            self.v[k] = self.v[k] * self.b2 + g * g * (1.0 - self.b2)
            denom = torch.sqrt(self.v[k]) / math.sqrt(bc2) + self.eps
            new = p - (self.lr / bc1) * self.m[k] / denom
            out[k] = p if k in frozen else new
        return out
