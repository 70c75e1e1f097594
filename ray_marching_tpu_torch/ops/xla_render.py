"""The plain march + normals with the fused kernel's plane contract
(counterpart of ``ray_marching_tpu/ops/xla_render.py``).

The JAX package evaluates this route with XLA instead of its Pallas kernel;
here it is the kernel's plain PyTorch version
(:func:`render_kernel._reference_march`) on whatever device the planes are
on, the same function that the kernel tests pin the kernels to, so the two
routes cannot drift. The four entry points have the signatures and plane
contracts of the fused ones:

- :func:`xla_march_normals`: rays7 ``(7, R, 128)`` → ``(8, R, 128)``,
  x y z d nx ny nz lap;
- :func:`xla_march_normals_cov`: + the along-ray closest approach ``min_f``
  → ``(9, R, 128)``;
- :func:`xla_march_normals_ift` / :func:`xla_march_normals_cov_ift`: the
  march without a graph, then the closed-form implicit-function-theorem
  backward that :func:`render_kernel.fused_march_normals_ift` uses
  (:class:`render_kernel._MarchIFT`): it reads only the endpoint (and the
  arg-min position), whichever march found them.

The first two are differentiated by autograd with every step
rematerialized (``torch.utils.checkpoint`` a step): the backward keeps the
position history, not each step's SDF activations, which for a wide MLP at
512² would take tens of GB. The remat is always on, as in the JAX package.
Nothing here launches a kernel.
"""

from __future__ import annotations

from ray_marching_tpu_torch.ops import render_kernel as rk


def xla_march_normals(program, params_flat, rays7, steps, tau, normals_eps,
                      mats=()):
    """rays7 (7, rows, 128) → (8, rows, 128): x y z d nx ny nz lap."""
    return rk._reference_march(program, params_flat, rays7, steps, tau,
                               normals_eps, mats=mats, remat=True)[0]


def xla_march_normals_cov(program, params_flat, rays7, steps, tau,
                          normals_eps, mats=()):
    """Coverage variant: + the ``min_f`` plane → (9, rows, 128)."""
    return rk._reference_march(program, params_flat, rays7, steps, tau,
                               normals_eps, track_min=True, mats=mats,
                               remat=True)[0]


def xla_march_normals_ift(program, params_flat, rays7, steps, tau,
                          normals_eps, hit_threshold=0.05, denom_eps=1e-6,
                          mats=()):
    """:func:`xla_march_normals` with the IFT endpoint backward (O(1)
    memory and time), the backward of ``fused_march_normals_ift``."""
    return rk.march_ift(program, params_flat, rays7, steps, tau, normals_eps,
                        hit_threshold, denom_eps, False, mats, plain=True)


def xla_march_normals_cov_ift(program, params_flat, rays7, steps, tau,
                              normals_eps, hit_threshold=0.05,
                              denom_eps=1e-6, mats=()):
    """Coverage + IFT: the ``min_f`` gradient through f at the arg-min
    position, held fixed, as ``fused_march_normals_ift(track_min=True)``."""
    return rk.march_ift(program, params_flat, rays7, steps, tau, normals_eps,
                        hit_threshold, denom_eps, True, mats, plain=True)
