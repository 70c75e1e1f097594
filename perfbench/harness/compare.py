"""The numbers that decide ``correct``, each held to its limit from the
cell's ``limits/<workload>.json``.

Training (the program's first steps against the reference's from the same
starting parameters, views and target), each taken by the worst leaf:

- ``loss_gap``: each of the first steps' loss against the reference's,
  ``|L - L_ref| / |L_ref|``, the largest; ``loss0_gap`` the first step's
  alone;
- ``grad_gap``: the first step's gradient as the optimizer got it, the gap
  between the program's norm of a leaf and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  ``grad_gap_arrays`` the same over the leaves of more than one value. A
  leaf of one value (an offset added to a field's output) has as its
  gradient one sum over every evaluation of every ray, whose terms can
  cancel twentyfold and more: in float32 it carries that sum's round-off,
  on either side;
- ``change1_gap``: the same of the parameters' change after the first
  step. A leaf whose reference gradient is under a thousandth of the
  median leaf's moves by round-off alone under Adam and is left out;
- ``adam_gap``: the optimizer's stage by itself. The reference's Adam takes
  the program's own first two gradients from the same start; the
  program's parameters after each of the two updates (over the update's
  norm) and its two moments after the second (over their norm) against
  it, the norm of the difference, the worst leaf and quantity. Nothing
  chaotic enters it, so it sees a moment reset or a wrong decay that the
  first step (about ``lr·sign(g)`` a value) cannot show.

A cell's limits file names the numbers it holds: where a fit's later steps
are chaotic (silhouette pixels decide the loss, and Adam's first steps
follow the gradient's signs), the first step's loss and change are the
steady ones. :func:`train_detail` gives, per step and leaf, what the
numbers are taken from, and the gap of the change after all the
reference's steps (``change_gap``), which no limit holds.

Serving (each sampled frame's bytes against the reference's image of the
pose the program rendered it at, ``e = |byte - 255·ref|`` per pixel and
channel), the worst frame:

- ``frame_excess``: the mean of ``max(e - 0.5, 0)``, what is left beyond
  the rounding;
- ``pose_gap``: the largest difference of a component of that pose (unit
  quaternion and position) from the reference's own integration of the
  scripted input in float64: the stage that reading the program's pose
  skips, checked by itself.

:func:`frame_detail` counts the values with ``e > 1`` (``frame_px_off``),
too coarse for a limit.

A number that is not finite fails.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.adam import Adam

#: A leaf whose reference gradient is under this share of the median
#: leaf's is left out of ``change_gap``.
ROUNDOFF_LEAF = 1e-3


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double().cpu()))


def _median(values):
    s = sorted(values)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def _worst_gap(prog_norms, ref_norms, med=None) -> float:
    """The worst leaf's gap of norms, over its reference norm or ``med``
    (by default the median of ``ref_norms``), whichever is larger."""
    med = _median(ref_norms.values()) if med is None else med
    worst = 0.0
    for k, r in ref_norms.items():
        scale = max(r, med)
        diff = abs(prog_norms[k] - r)
        gap = diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
        worst = max(worst, gap) if math.isfinite(gap) else math.inf
    return worst


def _moving(grad0, trainable):
    """The trainable leaves whose reference gradient is above round-off."""
    norms = {k: _norm(grad0[k]) for k in trainable}
    med = _median(norms.values())
    return [k for k in trainable if norms[k] >= ROUNDOFF_LEAF * med]


def _change(side, step, start, leaves):
    """Each leaf's change after ``step + 1`` steps."""
    return {k: _norm(side["params_after"][step][k].cpu() - start[k].cpu())
            for k in leaves}


def train_numbers(prog, ref, start, trainable, lr) -> dict:
    """``prog`` and ``ref``: :func:`perfbench.reference.fit.follow`'s record
    (``losses``, the first steps' ``grads``, ``params_after`` each step,
    ``moments`` after the second; the reference's may hold fewer steps than
    the program's); ``start``: the parameters both began from;
    ``trainable``: the leaves the fit moves; ``lr``: Adam's learning
    rate."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    loss_gap = max(losses) if all(map(math.isfinite, losses)) else math.inf
    g_ref = {k: _norm(ref["grads"][0][k]) for k in trainable}
    g_prog = {k: _norm(prog["grads"][0][k]) for k in trainable}
    moving = _moving(ref["grads"][0], trainable)
    arrays = [k for k in trainable if ref["grads"][0][k].numel() > 1]
    return {"loss_gap": loss_gap,
            "loss0_gap": losses[0] if math.isfinite(losses[0]) else math.inf,
            "grad_gap": _worst_gap(g_prog, g_ref),
            "grad_gap_arrays": _worst_gap(
                {k: g_prog[k] for k in arrays}, {k: g_ref[k] for k in arrays},
                _median(g_ref.values())),
            "change1_gap": _worst_gap(
                _change(prog, 0, start, moving),
                _change(ref, 0, start, moving)),
            "adam_gap": adam_gap(prog, start, moving, lr)}


def _rel(a, b, scale) -> float:
    diff = _norm(a.double().cpu() - b.double().cpu())
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def adam_gap(prog, start, leaves, lr) -> float:
    """The program's first two updates and its moments after them against
    the reference's Adam fed the program's own gradients."""
    s0 = {k: start[k].cpu().float() for k in leaves}
    g = [{k: prog["grads"][i][k].cpu().float() for k in leaves}
         for i in (0, 1)]
    p1, p2 = ({k: prog["params_after"][i][k].cpu().float() for k in leaves}
              for i in (0, 1))
    opt = Adam(s0, lr)
    r1 = opt.step(s0, g[0])
    r2 = opt.step(p1, g[1])
    m, v = prog["moments"]
    worst = 0.0
    for k in leaves:
        for gap in (_rel(p1[k], r1[k], _norm(r1[k] - s0[k])),
                    _rel(p2[k], r2[k], _norm(r2[k] - p1[k])),
                    _rel(m[k], opt.m[k], _norm(opt.m[k])),
                    _rel(v[k], opt.v[k], _norm(opt.v[k]))):
            worst = max(worst, gap) if math.isfinite(gap) else math.inf
    return worst


def train_detail(prog, ref, start, trainable) -> dict:
    """Per step and per leaf, what :func:`train_numbers` takes the worst
    of, and the gap of the leaves' change after all the reference's steps
    (``change_gap``), printed beside the numbers."""
    moving = _moving(ref["grads"][0], trainable)
    last = len(ref["params_after"]) - 1
    return {
        "losses": prog["losses"], "ref_losses": ref["losses"],
        "change_gap": _worst_gap(_change(prog, last, start, moving),
                                 _change(ref, last, start, moving)),
        "grad_norms": {k: [_norm(prog["grads"][0][k]),
                           _norm(ref["grads"][0][k])] for k in trainable},
        "change_norms": {k: [_change(side, i, start, [k])[k]
                             for side in (prog, ref) for i in (0, last)]
                         for k in trainable}}


def _errors(frame_bytes, ref_image):
    return (torch.as_tensor(frame_bytes).double()
            - 255.0 * ref_image.double().cpu()).abs()


def frame_numbers(frame_bytes, ref_image, pose, ref_pose) -> dict:
    """One frame: ``frame_bytes`` (H, W, 3) uint8, ``ref_image`` (H, W, 3)
    float in [0, 1] at the pose the program rendered it at; ``pose`` and
    ``ref_pose``: ``(q, t)`` of the program and of the reference."""
    e = _errors(frame_bytes, ref_image)
    excess = (float((e - 0.5).clamp(min=0.0).mean())
              if bool(torch.isfinite(e).all()) else math.inf)
    gap = max(float((torch.as_tensor(a).double().cpu().reshape(-1)
                     - torch.as_tensor(b).double().cpu().reshape(-1))
                    .abs().max()) for a, b in zip(pose, ref_pose))
    return {"frame_excess": excess,
            "pose_gap": gap if math.isfinite(gap) else math.inf}


def frame_detail(frame_bytes, ref_image) -> float:
    """The share of a frame's values more than one level off."""
    return float((_errors(frame_bytes, ref_image) > 1.0).double().mean())


def worst(per_frame) -> dict:
    keys = per_frame[0].keys()
    return {k: max(f[k] for f in per_frame) for k in keys}


def judge(numbers: dict, limits: dict):
    """``(correct, compared)``: every number that has a limit must be
    finite and at most its limit; ``compared`` pairs each with it."""
    compared, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = float(numbers.get(name, math.nan))
        finite = math.isfinite(value)
        compared[name] = {"value": value if finite else str(value),
                          "limit": spec["limit"]}
        if not (finite and value <= spec["limit"]):
            ok = False
    return ok, compared
