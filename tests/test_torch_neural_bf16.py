"""bf16 matrix operands: the port's renderer gradients against the JAX
package's (f32 with bf16 operands, CPU).

The port has one bf16 rule, the backward kernel's (scene/neural.py): the
cotangent of a layer's input is rounded to bf16, as autograd differentiates
its cast; the cotangent of a matrix (``a ⊗ δ`` summed over the rays and
evaluations) and of a bias stay f32 sums. The JAX package rounds each
backward tile's per-evaluation matrix sum to bf16 instead (its kernel
differentiates the cast inside every tile, ``pallas_backward.py``; its XLA
march, run here as its own CPU tests run it, rounds each evaluation's sum
over the frame, which at this size is one tile). Nothing else differs.

Derivation of the tolerances. Let ``S_e`` be one evaluation's matrix
cotangent summed over the frame. JAX returns ``Σ_e bf16(S_e)``, the port
``Σ_e S_e``; a bf16 rounding moves a value by at most 2^-9 of itself, so
the matrix gradients differ by at most ``2^-9 · Σ_e |S_e|``, entry by entry.
The ``S_e`` are measured here, on the port's plain backward, where each
evaluation's cast hands its matrix cotangent back (a hook on
``_bf16_operand``): they are the sums JAX rounds, to f32 rounding. The
flat leaves (biases, radius, the room) follow the same rule in both
packages; both round every layer input and its cotangent to bf16 after f32
sums taken in different orders, so a value near a rounding boundary may land
one bf16 ulp apart and the sweep carries it on: at most 2^-8 of the leaf's
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_marching_tpu.render.fast import FastRenderer as JaxFastRenderer
from ray_marching_tpu.render.pipeline import RenderConfig as JaxRenderConfig
from ray_marching_tpu.scene import graph as jgraph
from ray_marching_tpu.scene import neural as jneural
from ray_marching_tpu_torch.render.fast import FastRenderer
from ray_marching_tpu_torch.render.pipeline import RenderConfig
from ray_marching_tpu_torch.scene import graph as tgraph
from ray_marching_tpu_torch.scene import neural as tneural

PX = 3.45e-6
W, H, STEPS = 32, 24, 16
Q, T = np.asarray([[0.0, 0.0, 1.0, 0.0]]), np.asarray([[0.0, 0.2, 2.2]])


def _scene(graph, neural):
    """The room and a width-16 SIREN (``neural_demo``'s leaf, with the
    polynomial sine both packages evaluate alike) with bf16 operands."""
    return graph.Union(children=(
        graph.Onion(child=graph.Box(halfsides=(5.0, 5.0, 5.0)), radius=0.1),
        neural.NeuralSDF(hidden=(16, 16), seed=7, scale=0.6, w0=6.0,
                         activation="sine_fast", impl="matmul",
                         matmul_dtype="bfloat16")))


def _leaves(tree):
    return {k: _leaves(v) if isinstance(v, dict)
            else v.clone().requires_grad_(True) for k, v in tree.items()}


def test_bf16_renderer_gradients_match_jax(monkeypatch):
    """d Σ(render · weights) by every leaf, 32×24, 16 steps, mode 0: the
    matrices within 2^-9 · Σ_e |S_e| of JAX's, the flat leaves within 2^-8
    of their largest entry (module doc)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = dict(px_width=W, px_height=H, focal_length=PX * H,
               sensor_width=PX * W, sensor_height=PX * H,
               marching_steps=STEPS)
    jr = JaxFastRenderer(_scene(jgraph, jneural), JaxRenderConfig(**cfg),
                         dtype=jnp.float32, grid_dtype=np.float32,
                         march_impl="xla")
    tr = FastRenderer(_scene(tgraph, tneural), RenderConfig(**cfg),
                      dtype=torch.float32, device="cpu")
    # Trained-looking matrices (the last layer starts near zero).
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(lambda a: a, jr.init_params)
    for k in ("w0", "w1", "w2"):
        m = jp["c1"][k]
        jp["c1"][k] = m + jnp.asarray(
            rng.normal(size=m.shape) * 0.3 / m.shape[0], jnp.float32)
    weights = rng.normal(size=(1, H, W, 3))
    jq, jt = jnp.asarray(Q, jnp.float32), jnp.asarray(T, jnp.float32)
    want = jgraph.param_paths(jax.grad(lambda p: jnp.sum(
        jr.render(p, jq, jt, mode=0, degree=1) * weights))(jp))

    sums = {}  # transposed matrix shape -> Σ_e |S_e|
    cast = tneural._bf16_operand

    def recording(t):
        out = cast(t)
        if out.requires_grad:
            out.register_hook(lambda g, shape=tuple(t.shape): sums.__setitem__(
                shape, sums.get(shape, 0.0) + g.abs().double()))
        return out

    monkeypatch.setattr(tneural, "_bf16_operand", recording)
    params = tgraph.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    torch.float32)
    leaves = _leaves(params)
    try:
        (tr.render(leaves, Q, T, mode=0, degree=1)
         * torch.as_tensor(weights, dtype=torch.float32)).sum().backward()
    finally:
        torch.set_num_threads(threads)
    got = {k: v.grad for k, v in tgraph.param_paths(leaves).items()}

    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        gap = np.abs(got[path].double().numpy().reshape(w.shape) - w)
        if path.startswith("c1/w"):
            bound = 2.0 ** -9 * sums[w.shape[::-1]].numpy().T
            assert (gap <= bound).all(), (path, float((gap / bound).max()))
        else:
            assert gap.max() <= 2.0 ** -8 * np.abs(w).max(), path
        assert np.abs(w).max() > 0, path
