"""The work a cell needs, and the least time the chip could take for it.

Counted once, from the configuration's frozen numbers (``work``: operations
per SDF evaluation and per SDF VJP, of which matrix-product FLOPs, by the
convention of one per add, sub, mul, div, sqrt, select... on a quantity
that depends on the ray) and the cell's sizes:

- a forward ray: ``steps`` march evaluations, one terminal and four
  normal-offset evaluations, 6 operations a march step and 45 in the
  normals and shading tail; it reads its origin and direction (24 B) and
  writes its hit point and normal (24 B);
- a backward ray (training): the adjoint of each march step's evaluation
  and of the four normal offsets, ``steps + 4`` VJPs, each counted without
  the primal evaluation it contains (the forward counted that), plus the
  march and tail arithmetic again; it reads its origin, direction and the
  cotangents of its six outputs (48 B);
- parameters are read once and, in training, their gradients written once
  and Adam's two moments read and written once;
- a served frame's pixels are written once as three bytes.

No recompute or stored history is counted: those are one implementation's
choice. The least time is the largest of matrix FLOPs at the TF32 dense
rate, other operations at the float32 rate outside the tensor cores, and
bytes at the memory bandwidth (``peaks`` of the configuration, from the
data sheet).
"""

from __future__ import annotations

from dataclasses import dataclass

MARCH_STEP_OPS = 6
TAIL_OPS = 45
RAY_IO_BYTES = 24


@dataclass(frozen=True)
class Work:
    matmul_flops: float = 0.0
    other_ops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.matmul_flops + o.matmul_flops,
                    self.other_ops + o.other_ops, self.bytes + o.bytes)

    def least_seconds(self, peaks: dict) -> float:
        return max(self.matmul_flops / peaks["tf32_flops_per_s"],
                   self.other_ops / peaks["f32_flops_per_s"],
                   self.bytes / peaks["hbm_bytes_per_s"])


def forward_work(cfg, rays: int) -> Work:
    w, steps = cfg["work"], cfg["render"]["marching_steps"]
    evals = steps + 5
    return Work(
        matmul_flops=rays * evals * w["matmul_flops_per_eval"],
        other_ops=rays * (evals * (w["ops_per_eval"]
                                   - w["matmul_flops_per_eval"])
                          + steps * MARCH_STEP_OPS + TAIL_OPS),
        bytes=rays * 2 * RAY_IO_BYTES + 4 * w["param_scalars"])


def backward_work(cfg, rays: int) -> Work:
    w, steps = cfg["work"], cfg["render"]["marching_steps"]
    vjps = steps + 4
    adjoint = w["ops_per_vjp"] - w["ops_per_eval"]
    return Work(
        matmul_flops=rays * vjps * w["matmul_flops_per_vjp"],
        other_ops=rays * (vjps * (adjoint - w["matmul_flops_per_vjp"])
                          + steps * MARCH_STEP_OPS + TAIL_OPS),
        bytes=rays * 2 * RAY_IO_BYTES + 2 * 4 * w["param_scalars"])


def train_step_work(cfg, rays: int) -> Work:
    """A whole fit step: forward, backward, and Adam over every parameter
    (its moments read and written once)."""
    adam = Work(other_ops=12 * cfg["work"]["param_scalars"],
                bytes=4 * 4 * cfg["work"]["param_scalars"])
    return forward_work(cfg, rays) + backward_work(cfg, rays) + adam


def serve_frame_work(cfg, rays: int) -> Work:
    return forward_work(cfg, rays) + Work(bytes=3 * rays)
