"""The reference's inverse-rendering steps, and the weights file reader.

:func:`follow` takes the fit's first steps from the starting parameters:
each step renders every view, takes the loss and its gradient, and moves
the trainable leaves by Adam; frozen leaves keep their value. It returns
each step's loss, the first two steps' gradients, the parameters after
each step, and Adam's moments after the second.
"""

from __future__ import annotations

import ast

import numpy as np

from perfbench.reference.adam import Adam


def load_weights(path):
    """``{path: array}`` of a weights file whose entries are named
    ``leaf::['c1']['w0']`` (path ``c1/w0``)."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("leaf::"):
                parts = ast.literal_eval("[" + key[6:].replace("][", "],[")
                                         + "]")
                out["/".join(p[0] for p in parts)] = data[key]
    return out


def follow(ref, params, poses_for_step, target, lr, steps, frozen,
           adam=Adam):
    """The record of ``steps`` Adam steps: ``losses``, the first two
    steps' ``grads``, the parameters after each step (``params_after``),
    and Adam's ``moments`` ``(m, v)`` after the second.
    ``poses_for_step(i)`` gives step ``i``'s list of ``(q, t)``."""
    opt = adam(params, lr)
    rec = {"losses": [], "grads": [], "params_after": []}
    for i in range(steps):
        loss, grads = ref.loss_and_grad(params, poses_for_step(i), target)
        grads = {k: (0 * g if k in frozen else g) for k, g in grads.items()}
        rec["losses"].append(loss)
        if i < 2:
            rec["grads"].append(grads)
        params = opt.step(params, grads, frozen)
        rec["params_after"].append(params)
        if i == 1:
            rec["moments"] = ({k: v.clone() for k, v in opt.m.items()},
                              {k: v.clone() for k, v in opt.v.items()})
    return rec
