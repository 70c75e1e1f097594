"""Scene tree → kernel code.

The Pallas kernels of the JAX package trace the scene's ``sdf_c`` into the
kernel body; CUDA C++ has no tracer, so this module lowers a node tree to a
small SSA op list and emits it twice:

(a) :meth:`SdfProgram.cuda_source`: a CUDA C++ device function
    ``template <typename T> T scene_sdf(const T* P, T x, T y, T z)`` that
    reads every parameter at its offset in the flat vector of
    :func:`ray_marching_tpu_torch.ops.params.split_params_padded` (the
    values stay a runtime pointer, so new parameter values never rebuild);
(b) :meth:`SdfProgram.evaluate`: a tensor evaluator of the same op list.
    The tests hold it equal, bit for bit, to the plain SDF of
    :func:`ray_marching_tpu_torch.scene.graph.compile_node`, which catches a
    wrong offset, op order or tie rule in the generated code on a machine
    without ``nvcc``.

The backward kernel needs the SDF's vector-Jacobian product, which Pallas
gets by tracing ``jax.vjp`` into the kernel body. Here the adjoint is
emitted from the same op list, in reverse, one rule per op kind
(:func:`_append_adjoint`), as further SSA ops behind the primal ones. It is
emitted twice as well: ``scene_sdf_vjp`` in :meth:`SdfProgram.cuda_source`
and :meth:`SdfProgram.evaluate_vjp`, which the tests hold against
``torch.autograd.grad`` of :meth:`SdfProgram.evaluate`. A select sends its
cotangent to the chosen branch only (exact zeros to the other), ``abs`` has
slope 0 at 0, ``sqrt`` is ``g / (2·sqrt(x))``, and the smooth-union ``max``
follows ``torch.maximum`` (a tie takes half each). Values that depend on
parameters alone still carry a per-ray cotangent back to their parameters.

Each op of the list is one IEEE operation in the order of the plain SDF;
selects keep the select semantics of ``utils.vmin``/``vmax``/``clamp`` (a NaN
compare takes the false branch), and the smooth-union max propagates NaN like
``jnp.max``.

A ``NeuralSDF`` leaf (scene/neural.py) is its skip term ``sqrt(x·x + y·y +
z·z) - radius`` in ordinary ops plus one structural op, ``("mlp", leaf_id,
x, y, z)``: the scalar SSA list cannot hold a 65k-op MLP. Its sizes,
activation, ``w0``, impl and where its biases sit in the flat vector and its
matrices in the packed matrix buffer
(:func:`ray_marching_tpu_torch.ops.params.pack_mats`) are recorded in
:attr:`SdfProgram.mlps`. :meth:`SdfProgram.cuda_source` emits it as a call
into ``ops/csrc/neural.cuh`` with the sizes as compile-time constants,
:meth:`SdfProgram.evaluate` runs the port's own MLP evaluator on it. Its
adjoint is one more structural op, ``("mlp_vjp", leaf_id, x, y, z, g)``,
whose value is the point's cotangent (three ``pick`` ops read it): in CUDA
a call into neural.cuh's VJP, which walks back the hidden layers that the
``mlp`` op of ``scene_sdf_vjp`` kept (one forward per VJP) and hands the
matrix and bias cotangents to the backward kernel's per-block sink; on tensors
:func:`ray_marching_tpu_torch.scene.neural.mlp_vjp`, which
:meth:`SdfProgram.evaluate_vjp` returns them from. The radius goes through
the scalar rules.

A leaf of the shape :func:`tc_leaf` takes (matmul impl, ``3 -> N1 -> N2 ->
1`` with ``N1`` a multiple of 16 and ``N2`` a multiple of 8 up to 256) gets a
second device function, ``neural_leaf_tc_<k>``: the warp-cooperative
tensor-core evaluation of neural.cuh (``rm_mlp_tc``), whose hidden layer
reads the fragments that :func:`ray_marching_tpu_torch.ops.params.tc_fragments`
prepares, after the packed matrices (:attr:`SdfProgram.tc_mats`). The
header then defines ``SCENE_TC`` and ``scene_sdf`` takes a compile-time
switch, ``scene_sdf<T, true>`` calling the tensor-core function: the
tensor-core entries take it (f32), the per-thread ones keep
``scene_sdf<T>``. ``scene_sdf_vjp`` takes the same switch: with it, the
leaf's primal evaluation keeps the last hidden layer on the tensor cores
(``neural_leaf_keep_tc_<k>``) and its VJP is neural.cuh's warp-cooperative,
block-synchronous ``rm_mlp_tc_vjp`` (``neural_leaf_vjp_tc_<k>``), which reads
``Wᵀ``'s fragments after the forward's (:attr:`SdfProgram.tc_bwd`); without
it, the per-thread VJP as before. A scene without such a leaf generates the
source it did before the tensor-core evaluation existed, byte for byte. The
tensor evaluator and the op counts do not change.

Custom nodes other than ``NeuralSDF`` enter through
:func:`register_lowering`: a function that emits the node with the
builder's scalar ops, as ``scene/fractals.py`` does for the Mandelbulb. An
iteration is one counted loop (:meth:`_Builder.loop`): emitted once as a
rolled C++ loop, its adjoint a checkpointed reverse loop
(:func:`_loop_adjoint`: the trips' start states on a per-thread tape, each
trip recomputed from it, every sum in the unrolled adjoint's order), and
run as a Python loop on tensors.
Without one, a registered custom node raises ``NotImplementedError`` here
(``Renderer`` without ``use_pallas`` still runs it through its torch SDF).

The union short-circuit (``SdfProgram(node, prune=True)``, the JAX
package's ``compile_node(node, prune=True)``, :func:`graph.pruned_children`)
is a second op list of the same scene, ``scene_sdf_fwd``, emitted only when
some union child qualifies: each guarded child is a region of the list
(:meth:`_Builder.guard`) that the C++ enters per thread only where ``!(lb >
d)``, ``lb = |p - c|·(1 - 32 eps) - R`` against the running minimum ``d``;
the tensor evaluator (:meth:`SdfProgram.evaluate_fwd`) runs the region on
every point and selects, so both give the unpruned values. A region holds no
``mlp`` op and no loop (a bounded subtree has neither). The bounds ``(c,
R)`` come from the current parameters through a prologue of their own,
``scene_bounds`` (:func:`_lower_bound`, :func:`graph.bounding_sphere_fn`'s
rules), which a kernel runs once per thread; on the tensor cores the warp
meets at ``__syncwarp()`` after each region, before the next ``mma.sync``.
Only the forward kernels and the backward's marches take ``scene_sdf_fwd``;
``scene_sdf`` and ``scene_sdf_vjp`` are those of the unpruned program, and a
program without a guard generates the unpruned source byte for byte.

Op count convention (:meth:`SdfProgram.op_counts`, over the program with
its loops written out): one per add, sub, mul,
div, sqrt, exp, log, abs, neg, max and compare-select whose inputs depend on
the query point. Parameter loads and arithmetic on parameters alone are not
counted (they do not depend on the ray and may be hoisted out of the march).
Every adjoint op depends on the ray's cotangent, so all of them count
(:attr:`SdfProgram.vjp_ops_per_eval`). An MLP counts ``2·nin·nout`` per
layer (the multiplies, the sums and the bias adds), the scale of the first
layer's sine variants and its activation's ops per hidden unit (``sin`` and
``tanh`` count one each in the ``exp`` class, ``log1p`` in ``log``, the
rounding of ``sin_fast``'s reduction in ``abs_neg``; bf16 operand roundings
are not counted). Its VJP counts, beyond the one forward that the SDF VJP's
primal evaluation holds, each hidden unit's activation slope and δ,
``W·δ``, ``a ⊗ δ`` and the bias sums (:func:`_mlp_vjp_op_count`).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from ray_marching_tpu_torch.scene.graph import (
    Affine,
    Box,
    Disk,
    Line,
    Node,
    Onion,
    Plane,
    Rounding,
    SmoothUnion,
    Sphere,
    Torus,
    Union,
    _custom_entry,
    _unknown,
    compile_node,
    init_params,
    most_derived,
    pruned_children,
)
from ray_marching_tpu_torch.scene.neural import (
    NeuralSDF,
    mlp,
    mlp_vjp,
    resolve_impl,
)

# kind -> (arity, C++ expression template, count class)
_OPS = {
    "add": (2, "{0} + {1}", "add"),
    "sub": (2, "{0} - {1}", "add"),
    "mul": (2, "{0} * {1}", "mul"),
    "div": (2, "{0} / {1}", "div"),
    "neg": (1, "-{0}", "abs_neg"),
    "abs": (1, "rm_abs({0})", "abs_neg"),
    "sqrt": (1, "rm_sqrt({0})", "sqrt"),
    "exp": (1, "rm_exp({0})", "exp"),
    "log": (1, "rm_log({0})", "log"),
    "max": (2, "rm_max_nan({0}, {1})", "select"),
    # sel_lt(a, b, t, f) = a < b ? t : f; sel_gt and sel_le likewise with >
    # and <=. A NaN compare takes f in all three, as jnp.where does, so
    # where(a <= b, t, f) is sel_le and not sel_gt(a, b, f, t).
    "sel_lt": (4, "({0} < {1}) ? {2} : {3}", "select"),
    "sel_gt": (4, "({0} > {1}) ? {2} : {3}", "select"),
    "sel_le": (4, "({0} <= {1}) ? {2} : {3}", "select"),
    # Adjoint code only: the slope of abs, and the tie test of max.
    "sign": (1, "rm_sign({0})", "select"),
    "sel_eq": (4, "({0} == {1}) ? {2} : {3}", "select"),
}

COUNT_CLASSES = ("add", "mul", "div", "sqrt", "exp", "log", "abs_neg", "select")


class MlpLeaf(NamedTuple):
    """One ``NeuralSDF`` leaf of a program: the node, its parameter path,
    layer sizes ``(3, *hidden, 1)``, the flat offsets of its biases and
    radius, and the packed-buffer offsets of its matrices."""

    node: NeuralSDF
    prefix: str
    sizes: Tuple[int, ...]
    bias: Tuple[int, ...]
    radius: int
    mats: Tuple[int, ...]


def tc_leaf(leaf: MlpLeaf) -> bool:
    """Whether neural.cuh's tensor-core evaluation takes the leaf: matmul
    impl, two hidden layers, the hidden layer's input a multiple of 16 wide
    (the bf16 k-step) and its output a multiple of 8 up to 256 (the n-tile,
    and the accumulators a lane holds)."""
    sizes = leaf.sizes
    return (resolve_impl(leaf.node) == "matmul" and len(sizes) == 4
            and sizes[1] % 16 == 0 and sizes[2] % 8 == 0 and sizes[2] <= 256)


#: Activation name -> neural.cuh constant; any other name is tanh, as in
#: scene/neural.py (and the JAX package).
_ACT = {"sine": "RM_ACT_SINE", "sine_fast": "RM_ACT_SINE_FAST",
        "softplus": "RM_ACT_SOFTPLUS"}


def _mlp_op_counts(leaf: MlpLeaf) -> Dict[str, int]:
    """Ray-dependent ops of one evaluation of an MLP leaf (module doc)."""
    c = dict.fromkeys(COUNT_CLASSES, 0)
    sizes, act = leaf.sizes, leaf.node.activation
    for nin, nout in zip(sizes[:-1], sizes[1:]):
        c["mul"] += nin * nout
        c["add"] += nin * nout
    units = sum(sizes[1:-1])
    if act.startswith("sine") and len(sizes) > 2:
        c["mul"] += sizes[1]
    per_unit = {
        "sine_fast": {"mul": 10, "add": 7, "abs_neg": 1},
        "softplus": {"select": 2, "add": 2, "abs_neg": 2, "exp": 1, "log": 1},
    }.get(act, {"exp": 1})  # sine and tanh: one op each
    for k, v in per_unit.items():
        c[k] += v * units
    return c


#: Ops per hidden unit of an activation's slope beyond what the activation
#: already computed (sin_fast's reduction and polynomial, tanh's y, softplus'
#: exp), plus the multiply by the incoming cotangent.
_SLOPE_OPS = {"sine": 2, "sine_fast": 12, "softplus": 10}


def _mlp_vjp_op_count(leaf: MlpLeaf) -> int:
    """Ray-dependent ops of one MLP VJP beyond its forward, which the SDF
    VJP's primal evaluation counts (module doc): the activation slopes and
    δ, ``W·δ`` (a multiply and an add per weight; the output layer's
    multiplies only), ``a ⊗ δ`` (a multiply and an add per weight) and one
    add per bias."""
    sizes, act = leaf.sizes, leaf.node.activation
    units = sum(sizes[1:-1])
    slopes = _SLOPE_OPS.get(act, 3) * units
    if act.startswith("sine") and len(sizes) > 2:
        slopes += sizes[1]
    weights = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    back = 2 * weights - sizes[-2]
    return slopes + back + 2 * weights + sum(sizes[1:])


class _Loop:
    """A counted loop of the op list (:meth:`_Builder.loop`): ``n`` trips
    over the body ops between the ``carry`` ops and ``end``, which turn the
    state ``init`` into ``new`` each trip; ``out`` holds the final state.

    :func:`_loop_adjoint` fills in its reverse: ``seeds``, the cotangents of
    ``out`` that start the state's cotangent; ``inputs``, the values from
    before the loop that get cotangents from it (what the body reads, and
    the initial state), each with a running cotangent ``h`` that starts at
    ``input_seeds``; per reverse trip (``trips``: the rolled trips n-1..1,
    then trip 0 peeled) the ``rcarry_g`` ops that read the state's
    cotangent, the ids of the carries' cotangents at the trip's start
    (``next``, rolled trips only) and of each input's running cotangent at
    the trip's end (``input_end``: {input index: id}), and the markers that
    close it; ``input_out`` holds the inputs' cotangents after the loop."""

    def __init__(self, index, n, init, begin, carry, end, new, out):
        self.index, self.n, self.init = index, n, init
        self.begin, self.carry, self.end = begin, carry, end
        self.new, self.out = new, out
        self.seeds = self.next = None
        self.inputs, self.input_seeds, self.input_out = [], None, None
        self.trips = []  # (rcarry_g ids, input_end, closing marker id)

    @property
    def body(self) -> range:
        """The ids of the body's ops (the carries excluded)."""
        return range(self.carry[-1] + 1, self.end)


class _Guard(NamedTuple):
    """A guarded union child (:meth:`_Builder.guard`): the ops between the
    ``begin`` marker and ``end`` run only where ``lb > d`` does not hold;
    ``m`` is ``vmin(d, child)`` inside the region, and ``end`` holds ``m``
    there and ``d`` where the region was skipped. ``bound``: the guard's
    slot in the bounds prologue (``4 * bound`` .. ``4 * bound + 3`` hold cx,
    cy, cz, R); the ops from ``test`` to ``lb`` compute ``lb``."""

    bound: int
    test: int
    lb: int
    d: int
    begin: int
    m: int
    end: int


class _Form(NamedTuple):
    """One op list of a program: the ops, whether each depends on the ray,
    its counted loops and guarded regions, the id of the SDF's value and the
    length of the primal part (the adjoint follows it in the main list)."""

    ops: List[Tuple]
    dep: List[bool]
    loops: Tuple
    guards: Tuple
    out: int
    n_primal: int


class _Builder:
    """Appends SSA ops; value ids index the op list. Ids 0-2 are x, y, z.
    ``unroll``: :meth:`loop` writes its body out ``n`` times instead of
    emitting a loop (the op counts are taken from such a twin). ``prune``:
    unions guard the children :func:`graph.pruned_children` picks
    (:meth:`guard`), their bounds lowered into the parameter-only list
    ``bounds`` (:func:`_lower_bound`)."""

    def __init__(self, offsets: Dict[str, int],
                 mat_offsets: Dict[str, int] = None, unroll: bool = False,
                 prune: bool = False):
        self.offsets = offsets
        self.mat_offsets = mat_offsets or {}
        self.unroll = unroll
        self.ops: List[Tuple] = [("x",), ("y",), ("z",)]
        self.dep: List[bool] = [True, True, True]
        self.mlps: List[MlpLeaf] = []
        self.loops: List[_Loop] = []
        self.guards: List[_Guard] = []
        self.bounds = _Builder(offsets) if prune else None
        #: Ids in ``bounds`` of cx, cy, cz, R of each guard, in slot order.
        self.bound_ids: List[int] = []
        self._memo: Dict[Tuple, int] = {}
        self._in_body = False
        self._closed: List[range] = []  # the finished loop bodies, regions

    def loop(self, n: int, state, body):
        """A counted loop with carried state: ``body(builder, *state) ->
        state'`` emits one trip over the builder's ops, ``n`` trips run, and
        the final state's ids come back. The body reads the values of the
        ops before the loop as loop-invariant inputs; its constants and
        parameters are emitted ahead of the loop. It may not hold an ``mlp``
        op or another loop, and nothing after the loop may read its values
        but the returned state."""
        n, state = int(n), tuple(state)
        if self.unroll or n == 0:
            for _ in range(n):
                state = tuple(body(self, *state))
            return state
        if self._in_body:
            raise ValueError("loops do not nest")
        # A trial trip on a copy finds the body's constants and parameters.
        trial = _Builder(self.offsets, self.mat_offsets)
        trial.ops, trial.dep = list(self.ops), list(self.dep)
        trial._memo, trial._in_body = dict(self._memo), True
        body(trial, *state)
        if any(op[0] == "mlp" for op in trial.ops[len(self.ops):]):
            raise ValueError("a loop body may not hold an mlp op")
        for key in trial._memo:
            if key not in self._memo:
                self._memo[key] = self._push(key, False)
        index = len(self.loops)
        begin = self._push(("loop", index), True)
        carry = tuple(self._push(("carry", index, k), True)
                      for k in range(len(state)))
        self._in_body = True
        try:
            new = tuple(body(self, *carry))
        finally:
            self._in_body = False
        if len(new) != len(state):
            raise ValueError(f"the loop body returned {len(new)} values for "
                             f"a state of {len(state)}")
        end = self._push(("loop_end", index), True)
        self._closed.append(range(begin, end))
        out = tuple(self._push(("loop_out", index, k), True)
                    for k in range(len(state)))
        self.loops.append(_Loop(index, n, state, begin, carry, end, new, out))
        return out

    def guard(self, node, prefix, d, x, y, z, body):
        """Union child ``node`` at ``prefix`` behind the short-circuit (a
        child :func:`graph.pruned_children` picks; the builder was made with
        ``prune``): ``body(builder) -> id`` emits the child; returns the id
        of ``vmin(d, child)``, which is ``d`` wherever the guard skipped the
        child. Its bound's arithmetic goes to :attr:`bounds`; ``lb`` is
        computed ahead of the region, the region (the child and the vmin)
        holds no ``mlp`` op and no loop, and nothing after it reads its
        values but the result. Parameters and constants first read inside
        it are read there (and again after it, if needed)."""
        if self._in_body:
            raise ValueError("a guarded region inside a loop body")
        k = len(self.guards)
        self.guards.append(None)
        self.bound_ids += _lower_bound(node, self.bounds, prefix)
        cx, cy, cz, radius = (self._push(("bound", 4 * k + j), False)
                              for j in range(4))
        test = len(self.ops)
        ex, ey, ez = self.sub(x, cx), self.sub(y, cy), self.sub(z, cz)
        s = self.add(self.add(self.mul(ex, ex), self.mul(ey, ey)),
                     self.mul(ez, ez))
        eps = (torch.finfo(torch.float32).eps, torch.finfo(torch.float64).eps)
        shrink = self.tconst(*(1.0 - 32 * e for e in eps))
        lb = self.sub(self.mul(self.sqrt(s), shrink), radius)
        begin = self._push(("guard", k), True)
        memo = dict(self._memo)
        m = self.vmin(d, body(self))
        self._memo = memo
        if any(op[0] in ("mlp", "loop") for op in self.ops[begin + 1:]):
            raise ValueError("a guarded region may not hold an mlp op or a "
                             "loop")
        end = self._push(("guard_end", k), True)
        self._closed.append(range(begin, end))
        self.guards[k] = _Guard(k, test, lb, d, begin, m, end)
        return end

    def tconst(self, f32, f64):
        """A constant whose value depends on the evaluation's type."""
        key = ("tconst", float(f32), float(f64))
        if key not in self._memo:
            self._memo[key] = self._push(key, False)
        return self._memo[key]

    def _check_scope(self, args):
        for a in args:
            if any(a in r for r in self._closed):
                raise ValueError("a value of a loop body is read after the "
                                 "loop")

    def mlp(self, node: NeuralSDF, prefix: str, x: int, y: int, z: int):
        """The structural op of a neural leaf at (x, y, z)."""
        self._check_scope((x, y, z))
        n_layers = len(node.hidden) + 1
        self.mlps.append(MlpLeaf(
            node=node, prefix=prefix, sizes=(3,) + tuple(node.hidden) + (1,),
            bias=tuple(self.offsets[_path(prefix, f"b{i}")]
                       for i in range(n_layers)),
            radius=self.offsets[_path(prefix, "radius")],
            mats=tuple(self.mat_offsets[_path(prefix, f"w{i}")]
                       for i in range(n_layers))))
        return self._push(("mlp", len(self.mlps) - 1, x, y, z), True)

    def mlp_vjp(self, leaf_id, x, y, z, g):
        """The MLP's VJP at (x, y, z) for the cotangent ``g`` of its output:
        one value holding the point's cotangent (three ``pick`` ops read
        it); the matrix and bias cotangents go to the kernel's sink."""
        return self._push(("mlp_vjp", leaf_id, x, y, z, g), True)

    def pick(self, vec, c):
        return self._push(("pick", vec, c), True)

    def leaf(self, name):
        """A ray-dependent input besides x, y, z (the cotangent ``g``)."""
        return self._push((name,), True)

    def _push(self, op, dep):
        self.ops.append(op)
        self.dep.append(dep)
        return len(self.ops) - 1

    def param(self, path, index=0):
        key = ("param", self.offsets[path] + index)
        if key not in self._memo:
            self._memo[key] = self._push(key, False)
        return self._memo[key]

    def const(self, value):
        key = ("const", float(value))
        if key not in self._memo:
            self._memo[key] = self._push(key, False)
        return self._memo[key]

    def __getattr__(self, kind):
        if kind not in _OPS:
            raise AttributeError(kind)

        def emit(*args):
            assert len(args) == _OPS[kind][0], kind
            self._check_scope(args)
            return self._push((kind,) + args, any(self.dep[a] for a in args))

        return emit

    # Select forms of utils.vmin / vmax / clamp.
    def vmin(self, a, b):
        return self.sel_lt(b, a, b, a)

    def vmax(self, a, b):
        return self.sel_gt(b, a, b, a)

    def clamp01(self, v):
        zero, one = self.const(0.0), self.const(1.0)
        v = self.sel_lt(v, zero, zero, v)
        return self.sel_gt(v, one, one, v)


def _path(prefix, key):
    return f"{prefix}/{key}" if prefix else key


def _lower(node: Node, b: _Builder, prefix: str, x: int, y: int, z: int) -> int:
    """Emit ``node``'s SDF at (x, y, z), in the op order of the plain SDF
    (scene/primitives.py, scene/ops.py)."""
    p = lambda key, i=0: b.param(_path(prefix, key), i)  # noqa: E731
    if isinstance(node, Sphere):
        s = b.add(b.add(b.mul(x, x), b.mul(y, y)), b.mul(z, z))
        return b.sub(b.sqrt(s), p("radius"))
    if isinstance(node, Box):
        q = [b.sub(b.abs(c), p("halfsides", i)) for i, c in enumerate((x, y, z))]
        q_max = b.vmax(b.vmax(q[0], q[1]), q[2])
        zero = b.const(0.0)
        r = [b.sel_gt(qi, zero, qi, zero) for qi in q]
        s = b.add(b.add(b.mul(r[0], r[0]), b.mul(r[1], r[1])), b.mul(r[2], r[2]))
        inside = b.sel_lt(q_max, zero, q_max, zero)
        return b.add(b.sqrt(s), inside)
    if isinstance(node, Plane):
        return x
    if isinstance(node, Line):
        s = [p("start", i) for i in range(3)]
        e = [p("end", i) for i in range(3)]
        ab = [b.sub(e[i], s[i]) for i in range(3)]
        length2 = b.add(b.add(b.mul(ab[0], ab[0]), b.mul(ab[1], ab[1])),
                        b.mul(ab[2], ab[2]))
        ap = [b.sub(c, s[i]) for i, c in enumerate((x, y, z))]
        dot = b.add(b.add(b.mul(ap[0], ab[0]), b.mul(ap[1], ab[1])),
                    b.mul(ap[2], ab[2]))
        t = b.clamp01(b.div(dot, length2))
        dv = [b.sub(b.mul(t, ab[i]), ap[i]) for i in range(3)]
        s2 = b.add(b.add(b.mul(dv[0], dv[0]), b.mul(dv[1], dv[1])),
                   b.mul(dv[2], dv[2]))
        return b.sub(b.sqrt(s2), p("radius"))
    if isinstance(node, Disk):
        r_dist = b.sub(b.sqrt(b.add(b.mul(y, y), b.mul(z, z))), p("radius"))
        zero = b.const(0.0)
        rr = b.sel_gt(r_dist, zero, r_dist, zero)
        return b.sqrt(b.add(b.mul(x, x), b.mul(rr, rr)))
    if isinstance(node, Torus):
        a = b.sub(b.sqrt(b.add(b.mul(x, x), b.mul(z, z))), p("radius1"))
        return b.sub(b.sqrt(b.add(b.mul(a, a), b.mul(y, y))), p("radius2"))
    if isinstance(node, Affine):
        qw = p("orientation", 0)
        qx, qy, qz = (b.neg(p("orientation", i)) for i in (1, 2, 3))
        vx, vy, vz = (b.sub(c, p("translation", i))
                      for i, c in enumerate((x, y, z)))
        lx, ly, lz = _rotate(b, qw, qx, qy, qz, vx, vy, vz)
        return _lower(node.child, b, _path(prefix, "child"), lx, ly, lz)
    if isinstance(node, Union):
        guarded = (pruned_children(node) if b.bounds is not None
                   else [None] * len(node.children))
        out = _lower(node.children[0], b, _path(prefix, "c0"), x, y, z)
        for i, c in enumerate(node.children[1:], start=1):
            cp = _path(prefix, f"c{i}")
            if guarded[i] is None:
                out = b.vmin(out, _lower(c, b, cp, x, y, z))
            else:
                out = b.guard(c, cp, out, x, y, z,
                              lambda bb, c=c, cp=cp: _lower(c, bb, cp, x, y,
                                                            z))
        return out
    if isinstance(node, SmoothUnion):
        ds = [_lower(c, b, _path(prefix, f"c{i}"), x, y, z)
              for i, c in enumerate(node.children)]
        neg_k = b.neg(p("blend_k"))
        a = [b.mul(d, neg_k) for d in ds]
        m = a[0]
        for ai in a[1:]:
            m = b.max(m, ai)
        total = b.exp(b.sub(a[0], m))
        for ai in a[1:]:
            total = b.add(total, b.exp(b.sub(ai, m)))
        return b.div(b.add(b.log(total), m), neg_k)
    if isinstance(node, Rounding):
        d = _lower(node.child, b, _path(prefix, "child"), x, y, z)
        return b.sub(d, p("rounding"))
    if isinstance(node, Onion):
        d = _lower(node.child, b, _path(prefix, "child"), x, y, z)
        return b.sub(b.abs(d), p("radius"))
    if isinstance(node, NeuralSDF):
        # (sqrt(x·x + y·y + z·z) - radius) + mlp: the skip term as
        # ordinary ops (its adjoint, radius included, is the scalar rules').
        s = b.add(b.add(b.mul(x, x), b.mul(y, y)), b.mul(z, z))
        return b.add(b.sub(b.sqrt(s), p("radius")),
                     b.mlp(node, prefix, x, y, z))
    lower_fn = most_derived(_LOWERINGS, node)
    if lower_fn is not None:
        return lower_fn(node, b, prefix, x, y, z)
    if _custom_entry(node) is not None:
        raise NotImplementedError(
            f"{type(node).__name__}: a custom node without a kernel lowering; "
            "Renderer without use_pallas runs it through its torch SDF, and "
            "codegen.register_lowering(node_type, lower_fn) lets the kernels "
            "take it")
    return _unknown(node)


def _lower_bound(node: Node, b: _Builder, prefix: str) -> List[int]:
    """Emit ``node``'s bounding sphere (cx, cy, cz, R) from the parameters
    into the parameter-only list ``b``, by :func:`graph.bounding_sphere_fn`'s
    rules and expressions; the caller has checked that it has one."""
    p = lambda key, i=0: b.param(_path(prefix, key), i)  # noqa: E731
    zero = b.const(0.0)

    def norm(vx, vy, vz):
        return b.sqrt(b.add(b.add(b.mul(vx, vx), b.mul(vy, vy)),
                            b.mul(vz, vz)))

    if isinstance(node, (Sphere, Disk)):
        return [zero, zero, zero, b.abs(p("radius"))]
    if isinstance(node, Box):
        return [zero, zero, zero, norm(*(p("halfsides", i) for i in range(3)))]
    if isinstance(node, Torus):
        return [zero, zero, zero, b.add(b.abs(p("radius1")),
                                        b.abs(p("radius2")))]
    if isinstance(node, Line):
        half_c = b.const(0.5)
        c = [b.mul(b.add(p("start", i), p("end", i)), half_c)
             for i in range(3)]
        half = b.mul(norm(*(b.sub(p("end", i), p("start", i))
                            for i in range(3))), half_c)
        return c + [b.add(half, b.abs(p("radius")))]
    if isinstance(node, Affine):
        cx, cy, cz, r = _lower_bound(node.child, b, _path(prefix, "child"))
        q = [p("orientation", i) for i in range(4)]
        u = b.add(b.add(b.mul(q[1], q[1]), b.mul(q[2], q[2])),
                  b.mul(q[3], q[3]))
        a = b.sub(b.const(1.0), b.mul(b.const(2.0), u))
        m = b.sqrt(b.add(b.mul(a, a),
                         b.mul(b.mul(b.const(4.0), b.mul(q[0], q[0])), u)))
        eps = (torch.finfo(torch.float32).eps, torch.finfo(torch.float64).eps)
        # where(m >= 1 - 16 eps, |c| + r, inf), NaN m included.
        r_eff = b.sel_le(b.tconst(*(1.0 - 16 * e for e in eps)), m,
                         b.add(norm(cx, cy, cz), r), b.const(math.inf))
        return [p("translation", i) for i in range(3)] + [r_eff]
    if isinstance(node, (Union, SmoothUnion)):
        n = len(node.children)
        balls = [_lower_bound(c, b, _path(prefix, f"c{i}"))
                 for i, c in enumerate(node.children)]
        centre = []
        for j in range(3):
            total = balls[0][j]
            for ball in balls[1:]:
                total = b.add(total, ball[j])
            centre.append(b.div(total, b.const(n)))
        r = None
        for ball in balls:
            reach = b.add(ball[3], norm(*(b.sub(ball[j], centre[j])
                                          for j in range(3))))
            r = reach if r is None else b.max(r, reach)
        if isinstance(node, SmoothUnion):
            k = p("blend_k")
            r = b.sel_gt(k, zero, b.add(r, b.div(b.const(math.log(n)), k)),
                         b.const(math.inf))
        return centre + [r]
    if isinstance(node, Rounding):
        *c, r = _lower_bound(node.child, b, _path(prefix, "child"))
        return c + [b.add(r, p("rounding"))]
    if isinstance(node, Onion):
        *c, r = _lower_bound(node.child, b, _path(prefix, "child"))
        return c + [b.add(r, b.abs(p("radius")))]
    raise AssertionError(f"no bounding sphere: {node!r}")


#: Kernel lowerings of custom nodes: node type -> lower_fn.
_LOWERINGS: dict = {}


def register_lowering(node_type, lower_fn) -> None:
    """Let the kernels take a custom node (the counterpart of the JAX
    kernels tracing a registered node's SDF into their body).

    ``lower_fn(node, builder, prefix, x, y, z) -> id`` emits the node's SDF
    at the SSA values ``x, y, z`` with the builder's ops (``add``, ``sub``,
    ``mul``, ``div``, ``neg``, ``abs``, ``sqrt``, ``exp``, ``log``, ``max``,
    ``sel_lt``/``sel_gt``/``sel_le``, ``const(value)`` and
    ``param(param_path(prefix, key), index)`` for the node's parameters)
    and returns the id of its distance. Emit the ops of the node's torch
    SDF (the one :func:`graph.register_custom_node` was given) in its order:
    the tests hold :meth:`SdfProgram.evaluate` to it bit for bit, and the
    kernels' parity with their plain versions rests on that. The adjoint
    comes from the same ops.

    An iteration goes through ``builder.loop(n, state, body)``: ``body(
    builder, *state) -> state'`` emits one trip with the same ops (read the
    values from before the loop freely: they are its loop-invariant inputs;
    its constants and parameters are emitted ahead of it), ``n`` trips run,
    and the final state's ids come back; only those may be read after the
    loop. The kernels then hold one copy of the body: ``scene_sdf`` loops
    over it, ``scene_sdf_vjp`` keeps each trip's start state on a
    per-thread tape and runs the body's adjoint in a reverse loop that
    recomputes the trip from it and sums every cotangent in the order of
    the loop written out (the adjoint's bits are the unrolled one's).
    Write the torch SDF's iteration as a plain
    Python loop of the same ops (``scene/fractals.py`` writes both from one
    function over an arithmetic). A loop body may not hold an ``mlp`` op or
    another loop. ``node_type`` must subclass ``graph.Node``;
    the most-derived registered base of a node's type gives its lowering,
    as for ``graph.register_custom_node``."""
    if not (isinstance(node_type, type) and issubclass(node_type, Node)):
        raise TypeError(f"node_type must subclass Node, got {node_type!r}")
    _LOWERINGS[node_type] = lower_fn


def param_path(prefix: str, key: str) -> str:
    """The flat-vector path of parameter ``key`` of the node at ``prefix``
    (what a lowering hands to ``builder.param``)."""
    return _path(prefix, key)


def _cross(b, ux, uy, uz, vx, vy, vz):
    return (b.sub(b.mul(uy, vz), b.mul(uz, vy)),
            b.sub(b.mul(uz, vx), b.mul(ux, vz)),
            b.sub(b.mul(ux, vy), b.mul(uy, vx)))


def _rotate(b, qw, qx, qy, qz, x, y, z):
    """quat.rotate_c: ``v + w·t + q_v × t`` with ``t = 2 q_v × v``."""
    two = b.const(2.0)
    tx, ty, tz = (b.mul(two, t) for t in _cross(b, qx, qy, qz, x, y, z))
    cx, cy, cz = _cross(b, qx, qy, qz, tx, ty, tz)
    return tuple(b.add(b.add(c, b.mul(qw, t)), v)
                 for c, t, v in ((cx, tx, x), (cy, ty, y), (cz, tz, z)))


def _adjoint_rule(b, i, gi, acc):
    """Append the reverse-mode ops of op ``i`` for its cotangent ``gi``,
    handing each input's contribution to ``acc``. An op kind without a rule
    raises."""
    kind, args = b.ops[i][0], b.ops[i][1:]
    if kind == "add":
        acc(args[0], gi)
        acc(args[1], gi)
    elif kind == "sub":
        acc(args[0], gi)
        acc(args[1], b.neg(gi))
    elif kind == "mul":
        acc(args[0], b.mul(gi, args[1]))
        acc(args[1], b.mul(gi, args[0]))
    elif kind == "div":
        acc(args[0], b.div(gi, args[1]))
        acc(args[1], b.neg(b.mul(gi, b.div(i, args[1]))))
    elif kind == "neg":
        acc(args[0], b.neg(gi))
    elif kind == "abs":
        acc(args[0], b.mul(gi, b.sign(args[0])))
    elif kind == "sqrt":
        acc(args[0], b.div(gi, b.mul(b.const(2.0), i)))
    elif kind == "exp":
        acc(args[0], b.mul(gi, i))
    elif kind == "log":
        acc(args[0], b.div(gi, args[0]))
    elif kind == "max":
        zero, half = b.const(0.0), b.mul(gi, b.const(0.5))
        p, q = args
        acc(p, b.sel_gt(p, q, gi, b.sel_eq(p, q, half, zero)))
        acc(q, b.sel_gt(q, p, gi, b.sel_eq(p, q, half, zero)))
    elif kind in ("sel_lt", "sel_gt", "sel_le"):  # chosen branch only
        zero = b.const(0.0)
        sel = getattr(b, kind)
        acc(args[2], sel(args[0], args[1], gi, zero))
        acc(args[3], sel(args[0], args[1], zero, gi))
    elif kind == "mlp":
        vjp = b.mlp_vjp(args[0], args[1], args[2], args[3], gi)
        for c in range(3):
            acc(args[1 + c], b.pick(vjp, c))
    else:
        raise ValueError(f"no adjoint rule for op kind {kind!r}")


def _loop_adjoint(b, lp: _Loop, adj):
    """The reverse of loop ``lp``: trips n-1 .. 1 as a loop, last first,
    then trip 0 peeled. Each trip reads its start state from the forward
    loop's tape, recomputes the body from it and appends the body's adjoint
    once. The state's cotangent is carried from trip to trip (seeded by the
    cotangents of ``out``). Every value from before the loop that the loop
    gives a cotangent (an input the body reads, the initial state) has a
    running cotangent, started from the cotangent it already holds, which
    each contribution extends in turn; in trip 0 a carry's contributions are
    its initial value's. So every sum is taken in the order of the loop
    written out, and the reverse gives the unrolled adjoint's bits. After
    the loop the running cotangents are the inputs'."""
    for value in (0.0, 0.5, 2.0):  # the rules' constants, outside the loop
        b.const(value)
    L = lp.index
    lp.seeds = tuple(adj.get(o) for o in lp.out)
    where = {}  # input id -> its index in lp.inputs
    init_of = dict(zip(lp.carry, lp.init))

    def trip(peel, marker):
        b._push((marker, L), True)
        rg = tuple(b._push(("rcarry_g", L, k), True)
                   for k in range(len(lp.carry)))
        local, ends = {}, {}

        def lacc(arg, val):
            if peel and arg in init_of:
                arg = init_of[arg]
            if b.ops[arg][0] == "const":
                return
            if lp.begin < arg < lp.end:
                local[arg] = val if arg not in local else b.add(local[arg],
                                                                  val)
                return
            if arg not in where:
                where[arg] = len(lp.inputs)
                lp.inputs.append(arg)
            j = where[arg]
            if j not in ends:
                ends[j] = b._push(("rin_g", L, j), True)
            ends[j] = b.add(ends[j], val)

        for new, g in zip(lp.new, rg):
            lacc(new, g)
        for i in reversed(lp.body):
            if i in local and b.ops[i][0] not in ("param", "const"):
                _adjoint_rule(b, i, local[i], lacc)
        return rg, local, ends

    rg, local, ends = trip(False, "rloop")
    lp.next = tuple(local.get(c) for c in lp.carry)
    lp.trips.append((rg, ends, b._push(("rloop_end", L), True)))
    rg, _, ends = trip(True, "rpeel")
    lp.trips.append((rg, ends, b._push(("rpeel_end", L), True)))
    lp.input_seeds = tuple(adj.get(v) for v in lp.inputs)
    lp.input_out = tuple(b._push(("rloop_in", L, j), True)
                         for j in range(len(lp.inputs)))
    for v, r in zip(lp.inputs, lp.input_out):
        adj[v] = r


def _append_adjoint(b, out):
    """Append the reverse-mode ops of the primal list behind it.

    Returns ``(g, adj)``: the id of the cotangent input and a dict from a
    primal value id to the id that holds its cotangent (absent: no path
    from the output). Contributions to one value are summed in reverse op
    order, the first one without an add. A loop's adjoint is a reverse loop
    (:func:`_loop_adjoint`). An op kind without a rule raises."""
    n_primal = len(b.ops)
    b._closed = []  # the reverse loops read their bodies' values
    g = b.leaf("g")
    adj = {out: g}

    def acc(arg, val):
        if b.ops[arg][0] != "const":
            adj[arg] = val if arg not in adj else b.add(adj[arg], val)

    loop_ends = {lp.out[-1]: lp for lp in b.loops}
    i = n_primal - 1
    while i > 2:
        if i in loop_ends:
            lp = loop_ends[i]
            _loop_adjoint(b, lp, adj)
            i = lp.begin - 1
            continue
        if i in adj and b.ops[i][0] not in ("param", "const"):
            _adjoint_rule(b, i, adj[i], acc)
        i -= 1
    return g, adj


def _c_literal(value: float) -> str:
    if value == math.inf:  # a bound that never skips
        return "static_cast<T>(__int_as_float(0x7f800000))"
    return f"static_cast<T>({float(value).hex()})"


def _c_tconst(f32: float, f64: float) -> str:
    """A constant of the evaluation's type, chosen at compile time."""
    return (f"(sizeof(T) == 4 ? static_cast<T>({float(f32).hex()}) : "
            f"static_cast<T>({float(f64).hex()}))")


class SdfProgram:
    """A scene lowered to SSA ops, with its parameter layout; ``unroll``
    writes every loop of the lowering out (:meth:`_Builder.loop`);
    ``prune`` adds the union short-circuit's form ``scene_sdf_fwd`` where
    some union child qualifies (module doc; :attr:`pruned` says whether one
    did, with ``RM_TPU_PRUNE_MIN_LEAVES`` read now).

    ``specs`` is the flat-vector layout of
    :func:`ray_marching_tpu_torch.ops.params.split_params_padded` and
    ``n_flat`` the flat vector's length; ``mat_specs`` the packed matrix
    layout of :func:`ray_marching_tpu_torch.ops.params.pack_mats`;
    ``sdf_c``/:meth:`rebuild` give the plain SDF over the same inputs (the
    kernels' plain versions use them, pruned or not: the values are the
    same)."""

    def __init__(self, node: Node, unroll: bool = False, prune: bool = False):
        from ray_marching_tpu_torch.ops.params import (
            mat_specs,
            split_params_padded,
            tc_bwd_segment,
            tc_segment,
        )

        self._template = init_params(node, torch.float64)
        flat, _, specs = split_params_padded(self._template, torch.float64)
        self.node = node
        self.specs = specs
        self.mat_specs = mat_specs(self._template)
        self.n_flat = flat.shape[0]
        self.sdf_c = compile_node(node)
        b = _Builder({s.path: s.offset for s in specs},
                     {s.path: s.offset for s in self.mat_specs}, unroll)
        self.out = _lower(node, b, "", 0, 1, 2)
        self.n_primal = len(b.ops)
        #: The program's neural leaves, indexed by the ``mlp`` ops.
        self.mlps = tuple(b.mlps)
        # The short-circuit's form and its bounds prologue (None: no guard).
        self._fwd = self._bounds = None
        self._bound_ids = ()
        if prune:
            fb = _Builder(b.offsets, b.mat_offsets, unroll, prune=True)
            out = _lower(node, fb, "", 0, 1, 2)
            if fb.guards:
                assert tuple(fb.mlps) == self.mlps
                self._fwd = _Form(fb.ops, fb.dep, tuple(fb.loops),
                                  tuple(fb.guards), out, len(fb.ops))
                bb = fb.bounds
                self._bounds = _Form(bb.ops, bb.dep, (), (), None,
                                     len(bb.ops))
                self._bound_ids = tuple(fb.bound_ids)
        #: Flat-vector offset of every parameter scalar the scene has, in
        #: layout order: the compact index of the kernels' parameter
        #: cotangent (the 128-padding of the segments left out).
        self.scalar_offsets = [s.offset + j for s in specs
                               for j in range(s.size)]
        self.g, adj = _append_adjoint(b, self.out)
        self.adj_xyz = tuple(adj.get(i) for i in range(3))
        self._compact = {off: k for k, off in enumerate(self.scalar_offsets)}
        #: (compact scalar index, id of its per-ray cotangent), one per
        #: parameter scalar the output depends on through the scalar ops (a
        #: neural leaf's biases go through its VJP instead).
        self.adj_params = [(self._compact[b.ops[i][1]], a)
                           for i, a in adj.items() if b.ops[i][0] == "param"]
        #: The compact indices the kernel accumulates per thread, in order:
        #: every scalar for an analytic scene, the ``adj_params`` scalars
        #: for a scene with neural leaves.
        self.acc_scalars = (sorted({k for k, _ in self.adj_params})
                            if self.mlps else
                            list(range(len(self.scalar_offsets))))
        self.ops = b.ops
        self.ray_dependent = b.dep
        #: The program's counted loops (:meth:`_Builder.loop`).
        self.loops = tuple(b.loops)
        self._main = _Form(self.ops, self.ray_dependent, self.loops, (),
                           self.out, self.n_primal)
        # The op counts are those of the same scene with its loops written
        # out (``unroll``: the program the generator gave before it rolled
        # loops): the work itself, whatever the emitted code repeats.
        self._flat = (self.ops, self.ray_dependent, self.n_primal)
        if self.loops:
            self._flat = SdfProgram(node, unroll=True)._flat
        #: Tensor-core leaves: ``{leaf index: (index of the hidden layer's
        #: matrix in mat_specs, bf16 operands, fragment offset after the
        #: packed matrices)}``.
        self.tc = {}
        mat_index = {s.offset: k for k, s in enumerate(self.mat_specs)}
        off = 0
        for k, leaf in enumerate(self.mlps):
            if tc_leaf(leaf):
                bf16 = leaf.node.matmul_dtype == "bfloat16"
                self.tc[k] = (mat_index[leaf.mats[1]], bf16, off)
                off += tc_segment(leaf.sizes[1], leaf.sizes[2], bf16)
        #: Length of the tensor-core entries' buffer: the packed matrices,
        #: then the fragments (ops/params.py pack_tc).
        self.tc_size = self.mat_size + off
        #: The backward's tensor-core fragments (Wᵀ of each tensor-core
        #: layer, ops/params.py tc_bwd_fragments): ``{leaf index: offset
        #: after the packed matrices}``, behind the forward's fragments.
        self.tc_bwd = {}
        for k, (_, bf16, _) in self.tc.items():
            self.tc_bwd[k] = off
            sizes = self.mlps[k].sizes
            off += tc_bwd_segment(sizes[1], sizes[2], bf16)
        #: Length of the backward kernel's tensor-core buffer (pack_tc with
        #: ``backward``).
        self.tc_bwd_size = self.mat_size + off

    @property
    def tc_mats(self):
        """``(matrix index, bf16)`` of each tensor-core layer, in the order
        of their fragments after the packed matrices."""
        return tuple(v[:2] for v in self.tc.values())

    @property
    def n_mats(self) -> int:
        return len(self.mat_specs)

    @property
    def mat_size(self) -> int:
        """Length of the packed matrix buffer (ops/params.py pack_mats)."""
        from ray_marching_tpu_torch.ops.params import packed_size

        return packed_size(self.mat_specs)

    def rebuild(self, flat, mats=()):
        """Flat parameter vector and matrix tuple → nested params dict
        (views into ``flat``, the matrices as given)."""
        specs = {s.path: s for s in self.specs}
        mat_index = {s.path: k for k, s in enumerate(self.mat_specs)}

        def walk(tree, prefix):
            out = {}
            for key, val in tree.items():
                path = _path(prefix, key)
                if isinstance(val, dict):
                    out[key] = walk(val, path)
                elif path in mat_index:
                    out[key] = mats[mat_index[path]]
                else:
                    s = specs[path]
                    out[key] = flat[s.offset:s.offset + s.size].reshape(s.shape)
            return out

        return walk(self._template, "")

    def _leaf_params(self, flat, mats, leaf):
        params = self.rebuild(flat, mats)
        for key in filter(None, leaf.prefix.split("/")):
            params = params[key]
        return params

    @property
    def loop_trips(self) -> Tuple[int, ...]:
        """The trip count of each loop, in program order."""
        return tuple(lp.n for lp in self.loops)

    def _run(self, flat, vals, start, stop, mats=(), sink=None, tapes=None,
             form=None, bounds=None):
        """Run ops[start:stop] of ``form`` (the main list by default) on
        tensors into ``vals`` (a list indexed by op id); an MLP's VJP
        appends ``(leaf index, its parameter cotangents)`` to ``sink``; a
        forward loop keeps each trip's start state in ``tapes`` (by loop
        index) for its reverse loop. ``bounds``: the values of the bounds
        prologue's slots. A guarded region runs on every point, and its end
        selects ``d`` where ``lb > d``, as the kernel's branch skips it."""
        form = form or self._main
        i = start
        while i < stop:
            kind, args = form.ops[i][0], form.ops[i][1:]
            if kind == "loop":
                i = self._run_loop(flat, vals, form.loops[args[0]], mats,
                                   tapes, form)
                continue
            if kind == "rloop":
                i = self._run_rloop(flat, vals, self.loops[args[0]], mats,
                                    tapes)
                continue
            if kind == "param":
                v = flat[args[0]]
            elif kind == "rin_g":
                v = tapes[("h", args[0])][args[1]]
            elif kind == "const":
                v = torch.tensor(args[0], dtype=flat.dtype, device=flat.device)
            elif kind == "tconst":
                v = torch.tensor(args[0] if flat.dtype == torch.float32
                                 else args[1], dtype=flat.dtype,
                                 device=flat.device)
            elif kind == "bound":
                v = bounds[args[0]]
            elif kind == "guard":
                v = None
            elif kind == "guard_end":
                g = form.guards[args[0]]
                v = torch.where(vals[g.lb] > vals[g.d], vals[g.d], vals[g.m])
            elif kind == "mlp":
                leaf = self.mlps[args[0]]
                v = mlp(leaf.node)(self._leaf_params(flat, mats, leaf),
                                   *(vals[i] for i in args[1:]))
            elif kind == "mlp_vjp":
                leaf = self.mlps[args[0]]
                *v, grads = mlp_vjp(leaf.node,
                                    self._leaf_params(flat, mats, leaf),
                                    *(vals[i] for i in args[1:]))
                sink.append((args[0], grads))
            elif kind == "pick":
                v = vals[args[0]][args[1]]
            else:
                a = [vals[i] for i in args]
                if kind == "add":
                    v = a[0] + a[1]
                elif kind == "sub":
                    v = a[0] - a[1]
                elif kind == "mul":
                    v = a[0] * a[1]
                elif kind == "div":
                    v = a[0] / a[1]
                elif kind == "neg":
                    v = -a[0]
                elif kind == "abs":
                    v = torch.abs(a[0])
                elif kind == "sqrt":
                    v = torch.sqrt(a[0])
                elif kind == "exp":
                    v = torch.exp(a[0])
                elif kind == "log":
                    v = torch.log(a[0])
                elif kind == "max":
                    v = torch.maximum(a[0], a[1])
                elif kind == "sign":
                    v = torch.sign(a[0])
                elif kind == "sel_lt":
                    v = torch.where(a[0] < a[1], a[2], a[3])
                elif kind == "sel_gt":
                    v = torch.where(a[0] > a[1], a[2], a[3])
                elif kind == "sel_le":
                    v = torch.where(a[0] <= a[1], a[2], a[3])
                else:  # sel_eq
                    v = torch.where(a[0] == a[1], a[2], a[3])
            vals[i] = v
            i += 1
        return vals

    def _run_loop(self, flat, vals, lp, mats, tapes, form):
        """Loop ``lp`` on tensors; returns the id after its ``out`` ops."""
        state = [vals[a] for a in lp.init]
        tape = []
        for _ in range(lp.n):
            tape.append(state)
            for c, v in zip(lp.carry, state):
                vals[c] = v
            self._run(flat, vals, lp.body.start, lp.body.stop, mats,
                      form=form)
            state = [vals[a] for a in lp.new]
        if tapes is not None:
            tapes[lp.index] = tape
        for o, v in zip(lp.out, state):
            vals[o] = v
        return lp.out[-1] + 1

    def _run_rloop(self, flat, vals, lp, mats, tapes):
        """The reverse of ``lp`` on tensors (the C++ of
        :meth:`_rloop_source`); returns the id after its output ops."""
        zero = torch.full_like(vals[self.g], -0.0)  # see _rloop_source
        gc = [zero if a is None else vals[a] for a in lp.seeds]
        h = tapes[("h", lp.index)] = [zero if a is None else vals[a]
                                      for a in lp.input_seeds]
        for trip in reversed(range(lp.n)):
            rg, ends, stop = lp.trips[trip == 0]
            for c, v in zip(lp.carry, tapes[lp.index][trip]):
                vals[c] = v
            self._run(flat, vals, lp.body.start, lp.body.stop, mats)
            for r, v in zip(rg, gc):
                vals[r] = v
            self._run(flat, vals, rg[-1] + 1, stop, mats, tapes=tapes)
            for j, e in ends.items():
                h[j] = vals[e]
            if trip:
                gc = [zero if a is None else vals[a] for a in lp.next]
        for r, v in zip(lp.input_out, h):
            vals[r] = v
        return lp.input_out[-1] + 1 if lp.input_out else lp.trips[1][2] + 1

    def _values(self, x, y, z, form=None):
        vals = [None] * len((form or self._main).ops)
        vals[:3] = x, y, z
        return vals

    def evaluate(self, flat, x, y, z, mats=()):
        """Backend (b): run the primal op list on tensors."""
        return self._run(flat, self._values(x, y, z), 3, self.n_primal,
                         mats)[self.out]

    @property
    def pruned(self) -> bool:
        """Whether the program has the short-circuit's form (a guard)."""
        return self._fwd is not None

    def bound_values(self, flat):
        """The bounds prologue on ``flat``: cx, cy, cz, R of each guard."""
        vals = self._run(flat, self._values(None, None, None, self._bounds),
                         3, self._bounds.n_primal, form=self._bounds)
        return [vals[i] for i in self._bound_ids]

    def evaluate_fwd(self, flat, x, y, z, mats=()):
        """Backend (b) of ``scene_sdf_fwd``: the short-circuit's form on
        tensors, each guard a select (:meth:`_run`); the unpruned
        :meth:`evaluate` for a program without a guard."""
        if not self.pruned:
            return self.evaluate(flat, x, y, z, mats)
        f = self._fwd
        return self._run(flat, self._values(x, y, z, f), 3, f.n_primal,
                         mats, form=f, bounds=self.bound_values(flat))[f.out]

    def evaluate_vjp(self, flat, x, y, z, g, mats=()):
        """Backend (b) of the adjoint: ``(d, gx, gy, gz, gp)`` for the
        cotangent ``g`` of ``d``. ``gp`` holds the per-ray parameter
        cotangents, one tensor per entry of :attr:`scalar_offsets` (``None``
        where the output does not depend on the scalar; a neural leaf's
        biases included); their sums over the rays are the gradient of the
        flat vector. Then, for a scene with neural leaves, one cotangent per
        matrix (:attr:`mat_specs` order), already summed over the rays."""
        tapes = {}
        vals = self._run(flat, self._values(x, y, z), 3, self.n_primal, mats,
                         tapes=tapes)
        vals[self.g] = g
        sink = []
        self._run(flat, vals, self.n_primal + 1, len(self.ops), mats, sink,
                  tapes)
        d = vals[self.out]
        gxyz = [torch.zeros_like(g) if a is None else vals[a]
                for a in self.adj_xyz]
        gp = [None] * (len(self.scalar_offsets) + self.n_mats)
        for k, a in self.adj_params:
            gp[k] = vals[a]
        mat_index = {s.offset: k for k, s in enumerate(self.mat_specs)}
        for leaf_id, grads in sink:
            leaf = self.mlps[leaf_id]
            for layer, (b, m) in enumerate(zip(leaf.bias, leaf.mats)):
                base = self._compact[b]
                for j, db in enumerate(grads[f"b{layer}"]):
                    gp[base + j] = db.reshape(d.shape)
                gp[len(self.scalar_offsets) + mat_index[m]] = \
                    grads[f"w{layer}"]
        return (d, *gxyz, gp)

    def _loop_source(self, names, lp: _Loop, vjp, tape,
                     form=None) -> List[str]:
        """C++ of loop ``lp``: the state in variables ``c<L>_<k>``, the
        body once, unrolled by ``rm_sdf_loop_unroll`` (sdf_prims.cuh); with
        ``tape`` (the VJP) rolled, each trip's start state going to the
        arrays ``t<L>_<k>`` for the reverse loop."""
        L, it = lp.index, f"i{lp.index}"
        lines = [f"  T c{L}_{k} = {names[a]};" for k, a in enumerate(lp.init)]
        if tape:
            lines += [f"  T t{L}_{k}[{lp.n}];" for k in range(len(lp.init))]
        lines += ["#pragma unroll 1" if tape
                  else "#pragma unroll (rm_sdf_loop_unroll)",
                  f"  for (int {it} = 0; {it} < {lp.n}; ++{it}) {{"]
        if tape:
            lines += [f"    t{L}_{k}[{it}] = c{L}_{k};"
                      for k in range(len(lp.init))]
        lines += [f"    const T {names[c]} = c{L}_{k};"
                  for k, c in enumerate(lp.carry)]
        lines += ["  " + ln for ln in self._emit(names, lp.body.start,
                                                  lp.body.stop, vjp,
                                                  form=form)]
        lines += [f"    c{L}_{k} = {names[a]};" for k, a in enumerate(lp.new)]
        return lines + ["  }"] + [f"  const T {names[o]} = c{L}_{k};"
                                  for k, o in enumerate(lp.out)]

    def _rloop_source(self, names, lp: _Loop, vjp) -> List[str]:
        """C++ of the reverse of ``lp``: the state's cotangent in
        ``g<L>_<k>``, each input's running cotangent in ``h<L>_<j>``; trips
        n-1 .. 1 as a rolled loop, then trip 0 in a block of its own. Each
        trip reads its start state from the tape, recomputes the body and
        runs the body's adjoint."""
        # A sum without a term yet starts at -0, which adds no rounding and
        # keeps the first term's sign: the unrolled adjoint's "first term
        # without an add".
        L, zero = lp.index, "static_cast<T>(-0.0)"
        lines = [f"  T g{L}_{k} = {zero if a is None else names[a]};"
                 for k, a in enumerate(lp.seeds)]
        lines += [f"  T h{L}_{j} = {zero if a is None else names[a]};"
                  for j, a in enumerate(lp.input_seeds)]

        def trip(index, rg, ends, stop):
            out = [f"    const T {names[c]} = t{L}_{k}[{index}];"
                   for k, c in enumerate(lp.carry)]
            out += ["  " + ln for ln in self._emit(names, lp.body.start,
                                                    lp.body.stop, vjp)]
            out += [f"    const T {names[r]} = g{L}_{k};"
                    for k, r in enumerate(rg)]
            out += ["  " + ln for ln in self._emit(names, rg[-1] + 1, stop,
                                                    vjp)]
            return out + [f"    h{L}_{j} = {names[e]};"
                          for j, e in sorted(ends.items())]

        if lp.n > 1:
            it = f"i{L}"
            lines += ["#pragma unroll 1",
                      f"  for (int {it} = {lp.n - 1}; {it} >= 1; --{it}) {{"]
            lines += trip(it, *lp.trips[0])
            lines += [f"    g{L}_{k} = {zero if a is None else names[a]};"
                      for k, a in enumerate(lp.next)]
            lines.append("  }")
        lines += ["  {"] + trip(0, *lp.trips[1]) + ["  }"]
        return lines + [f"  const T {names[r]} = h{L}_{j};"
                        for j, r in enumerate(lp.input_out)]

    def _emit(self, names, start, stop, vjp=False, tape=False, form=None):
        """C++ of ops[start:stop] of ``form`` (the main list by default);
        ``vjp``: inside ``scene_sdf_vjp``, where an MLP's forward keeps its
        hidden layers for its VJP (``keep<k>``) and an inactive thread skips
        it; ``tape``: the forward loops keep their trips' start states for
        the reverse loops."""
        form = form or self._main
        lines = []
        nxt = start
        while nxt < stop:
            i = nxt
            kind, args = form.ops[i][0], form.ops[i][1:]
            if kind == "loop":
                lp = form.loops[args[0]]
                lines += self._loop_source(names, lp, vjp, tape, form)
                nxt = lp.out[-1] + 1
                continue
            if kind == "guard":
                g = form.guards[args[0]]
                lines += [f"  T {names[g.end]} = {names[g.d]};",
                          f"  if (!({names[g.lb]} > {names[g.d]})) {{"]
                lines += ["  " + ln for ln in self._emit(
                    names, g.begin + 1, g.m + 1, form=form)]
                lines += [f"    {names[g.end]} = {names[g.m]};", "  }"]
                if self.tc:  # the warp meets again before the next mma.sync
                    lines.append("  if constexpr (TC) __syncwarp();")
                nxt = g.end + 1
                continue
            if kind == "rloop":
                lp = self.loops[args[0]]
                lines += self._rloop_source(names, lp, vjp)
                nxt = (lp.input_out[-1] if lp.input_out
                       else lp.trips[1][2]) + 1
                continue
            nxt = i + 1
            ctype = "T"
            xyz = (", ".join(names[a] for a in args[1:4])
                   if kind in ("mlp", "mlp_vjp") else None)
            if kind == "param":
                expr = f"P[{args[0]}]"
            elif kind == "const":
                expr = _c_literal(args[0])
            elif kind == "tconst":
                expr = _c_tconst(*args)
            elif kind == "bound":
                expr = f"B.v[{args[0]}]"
            elif kind == "mlp" and vjp and args[0] in self.tc:
                lines += [
                    f"  T {names[i]};",
                    "  if constexpr (TC) {",
                    f"    {names[i]} = neural_leaf_keep_tc_{args[0]}(P, M, "
                    f"{xyz}, keep{args[0]});",
                    "  } else {",
                    f"    {names[i]} = sink.active ? neural_leaf_keep_{args[0]}"
                    f"<T>(P, M, {xyz}, keep{args[0]}) : static_cast<T>(0);",
                    "  }",
                ]
                continue
            elif kind == "mlp" and vjp and self._keeps(args[0]):
                expr = (f"sink.active ? neural_leaf_keep_{args[0]}<T>(P, M, "
                        f"{xyz}, keep{args[0]}) : static_cast<T>(0)")
            elif kind == "mlp" and not vjp and args[0] in self.tc:
                lines += [
                    f"  T {names[i]};",
                    "  if constexpr (TC) {",
                    f"    {names[i]} = neural_leaf_tc_{args[0]}(P, M, {xyz});",
                    "  } else {",
                    f"    {names[i]} = neural_leaf_{args[0]}<T>(P, M, {xyz});",
                    "  }",
                ]
                continue
            elif kind == "mlp":
                expr = f"neural_leaf_{args[0]}<T>(P, M, {xyz})"
                if vjp:
                    expr = f"sink.active ? {expr} : static_cast<T>(0)"
            elif kind == "mlp_vjp" and args[0] in self.tc:
                call = (f"(P, M, {xyz}, {names[args[4]]}, keep{args[0]}, "
                        "sink);")
                lines += [
                    f"  RmVec3<T> {names[i]};",
                    "  if constexpr (TC) {",
                    f"    {names[i]} = neural_leaf_vjp_tc_{args[0]}{call}",
                    "  } else {",
                    f"    {names[i]} = neural_leaf_vjp_{args[0]}<T>{call}",
                    "  }",
                ]
                continue
            elif kind == "mlp_vjp":
                ctype = "RmVec3<T>"
                keep = (f"keep{args[0]}" if self._keeps(args[0])
                        else "static_cast<T*>(nullptr)")
                expr = (f"neural_leaf_vjp_{args[0]}<T>(P, M, {xyz}, "
                        f"{names[args[4]]}, {keep}, sink)")
            elif kind == "pick":
                expr = f"{names[args[0]]}.v[{args[1]}]"
            elif kind == "rin_g":
                expr = f"h{args[0]}_{args[1]}"
            else:
                expr = _OPS[kind][1].format(*(names[a] for a in args))
            lines.append(f"  const {ctype} {names[i]} = {expr};")
        return lines

    def _keeps(self, k: int) -> bool:
        """Whether neural leaf ``k`` has hidden layers for its VJP to keep."""
        return len(self.mlps[k].sizes) > 2

    def _leaf_flags(self, leaf: MlpLeaf):
        node = leaf.node
        matmul = resolve_impl(node) == "matmul"
        return (f"{_ACT.get(node.activation, 'RM_ACT_TANH')}, "
                f"{str(matmul).lower()}, "
                f"{str(matmul and node.matmul_dtype == 'bfloat16').lower()}")

    def _mlp_source(self, k: int, leaf: MlpLeaf) -> List[str]:
        """The device function of neural leaf ``k``'s MLP (the skip term is
        generated code around it): calls into neural.cuh with the layer
        sizes as compile-time constants."""
        node, sizes = leaf.node, leaf.sizes
        flags = self._leaf_flags(leaf)
        sine = node.activation.startswith("sine")
        b = [f"P + {o}" for o in leaf.bias]
        m = [f"M + {o}" for o in leaf.mats]
        lines = [
            f"// {leaf.prefix or 'scene'}: NeuralSDF "
            f"{'-'.join(map(str, sizes))}, {node.activation}, "
            f"{resolve_impl(node)}, {node.matmul_dtype}",
            "template <typename T>",
            f"__device__ __noinline__ T neural_leaf_{k}(const T* __restrict__"
            " P, const T* __restrict__ M, T x, T y, T z) {",
            f"  const T w0 = {_c_literal(node.w0)};",
            "  const RmXyz<T> in = {{x, y, z}};",
        ]
        n_hidden = len(sizes) - 2
        if n_hidden == 0:
            lines += [
                "  T out[1];",
                f"  rm_dense_chunk<T, 3, 1, 1, {flags.split(', ', 1)[1]}>("
                f"{b[0]}, {m[0]}, in, 0, out);",
                "  return out[0];",
            ]
        else:
            hmax = max(sizes[1:-1])
            if n_hidden > 1:
                lines.append(f"  T ha[{hmax}];")
            if n_hidden > 2:
                lines.append(f"  T hb[{hmax}];")
            src, bufs = "in", ["ha", "hb"]
            for layer in range(n_hidden - 1):
                dst = bufs[layer % 2]
                scale = str(sine and layer == 0).lower()
                lines.append(
                    f"  rm_mlp_layer<T, {sizes[layer]}, {sizes[layer + 1]}, "
                    f"{flags}, {scale}>({b[layer]}, {m[layer]}, w0, {src}, "
                    f"{dst});")
                src = dst
            last = n_hidden - 1
            scale = str(sine and last == 0).lower()
            lines.append(
                f"  return rm_mlp_last<T, {sizes[last]}, "
                f"{sizes[last + 1]}, {flags}, {scale}>({b[last]}, "
                f"{m[last]}, w0, {src}, {b[last + 1]}, {m[last + 1]});")
        return lines + ["}", ""]

    def _mlp_tc_source(self, k: int, leaf: MlpLeaf) -> List[str]:
        """The tensor-core device functions of neural leaf ``k`` (f32): the
        warp-cooperative rm_mlp_tc of neural.cuh, its hidden layer's
        fragments after the packed matrices; the backward's primal
        evaluation of it, which keeps the last hidden layer (``keep_tc``);
        and its VJP, rm_mlp_tc_vjp, whose cotangents go to the block's row
        (``vjp_tc``)."""
        node, sizes = leaf.node, leaf.sizes
        _, bf16, frag = self.tc[k]
        act = _ACT.get(node.activation, "RM_ACT_TANH")
        scale = str(node.activation.startswith("sine")).lower()
        flags = f"{sizes[1]}, {sizes[2]}, {act}, {str(bf16).lower()}, {scale}"
        w0 = f"static_cast<float>({float(node.w0).hex()})"
        args = (f"P + {leaf.bias[0]}, M + {leaf.mats[0]}, P + {leaf.bias[1]}, "
                f"M + {self.mat_size + frag}, P + {leaf.bias[2]}, "
                f"M + {leaf.mats[2]}, {w0}, x, y, z")
        head = ("(const float* __restrict__ P, const float* __restrict__ M, "
                "float x, float y, float z")
        mats = [f"mats + {o}" for o in leaf.mats]
        rows = [f"row + {self._compact[o]}" for o in leaf.bias]
        return [
            f"// {leaf.prefix or 'scene'}: the same MLP on the tensor cores; "
            "every lane of the warp calls",
            f"static __device__ __noinline__ float neural_leaf_tc_{k}{head}) {{",
            f"  return rm_mlp_tc<{flags}>({args});",
            "}",
            "",
            "// Its backward: the primal keeping the last hidden layer, and the",
            "// VJP; every thread of the block calls",
            f"static __device__ __noinline__ float neural_leaf_keep_tc_{k}"
            f"{head}, float* keep) {{",
            f"  return rm_mlp_tc<{flags}, true>({args}, keep);",
            "}",
            "",
            f"static __device__ __noinline__ RmVec3<float> "
            f"neural_leaf_vjp_tc_{k}{head}, float g, float* keep, const "
            "RmSink<float>& sink) {",
            "  float* const row = sink.row;",
            "  float* const mats = sink.row + SCENE_N_SCALARS;",
            f"  return rm_mlp_tc_vjp<{flags}>(P + {leaf.bias[0]}, "
            f"M + {leaf.mats[0]}, M + {self.mat_size + self.tc_bwd[k]}, "
            f"M + {leaf.mats[2]}, {w0}, x, y, z, g, keep, sink, {mats[0]}, "
            f"{rows[0]}, {mats[1]}, {rows[1]}, {mats[2]}, {rows[2]});",
            "}",
            "",
        ]

    @staticmethod
    def _keep_offsets(leaf: MlpLeaf) -> List[int]:
        """Offsets of hidden layer l's output (``off[l - 1]``) and slope
        (``off[l - 1]`` + width) in the leaf's keep array, then its size."""
        off = [0]
        for n in leaf.sizes[1:-1]:
            off.append(off[-1] + 2 * n)
        return off

    def _mlp_keep_source(self, k: int, leaf: MlpLeaf) -> List[str]:
        """The SDF VJP's forward of neural leaf ``k``'s MLP: as
        :meth:`_mlp_source`, to the bit, but every hidden layer's output and
        slope go to the keep array for the VJP (neural.cuh)."""
        node, sizes = leaf.node, leaf.sizes
        flags = self._leaf_flags(leaf)
        sine = node.activation.startswith("sine")
        off = self._keep_offsets(leaf)
        lines = [
            "template <typename T>",
            f"__device__ __noinline__ T neural_leaf_keep_{k}(const T* "
            "__restrict__ P, const T* __restrict__ M, T x, T y, T z, "
            "T* keep) {",
            f"  const T w0 = {_c_literal(node.w0)};",
            "  const RmXyz<T> in = {{x, y, z}};",
        ]
        src = "in"
        for layer in range(len(sizes) - 2):
            n = sizes[layer + 1]
            scale = str(sine and layer == 0).lower()
            lines.append(
                f"  rm_mlp_layer_keep<T, {sizes[layer]}, {n}, {flags}, "
                f"{scale}>(P + {leaf.bias[layer]}, M + {leaf.mats[layer]}, "
                f"w0, {src}, keep + {off[layer]}, keep + {off[layer] + n});")
            src = f"keep + {off[layer]}"
        lines.append(
            f"  return rm_mlp_out<T, {sizes[-2]}, "
            f"{flags.split(', ', 1)[1]}>(P + {leaf.bias[-1]}, "
            f"M + {leaf.mats[-1]}, {src});")
        return lines + ["}", ""]

    def _mlp_vjp_source(self, k: int, leaf: MlpLeaf) -> List[str]:
        """The VJP of neural leaf ``k``'s MLP: the point's cotangent through
        the MLP for the cotangent ``g`` of its output, the matrix and bias
        cotangents into the block's sink (neural.cuh). It walks back the
        hidden layers that :meth:`_mlp_keep_source` kept, recomputing
        none."""
        node, sizes = leaf.node, leaf.sizes
        flags = self._leaf_flags(leaf)
        sine = node.activation.startswith("sine")
        L = len(sizes) - 2
        off = self._keep_offsets(leaf)
        m = [f"M + {o}" for o in leaf.mats]
        dw = [f"mats + {o}" for o in leaf.mats]
        db = [f"row + {self._compact[o]}" for o in leaf.bias]
        bf16 = flags.rsplit(", ", 1)[1]
        # a[l], s[l]: output and slope of hidden layer l (1 .. L).
        a = ["in"] + [f"keep + {off[layer - 1]}" for layer in range(1, L + 1)]
        s = [None] + [f"keep + {off[layer - 1] + sizes[layer]}"
                      for layer in range(1, L + 1)]
        lines = [
            "template <typename T>",
            f"__device__ __noinline__ RmVec3<T> neural_leaf_vjp_{k}(const T* "
            "__restrict__ P, const T* __restrict__ M, T x, T y, T z, T g, "
            "T* keep, const RmSink<T>& sink) {",
            f"  const T w0 = {_c_literal(node.w0)};",
            "  const RmXyz<T> in = {{x, y, z}};",
            "  RmVec3<T> gin = {{static_cast<T>(0), static_cast<T>(0), "
            "static_cast<T>(0)}};",
            "  T* const row = sink.row;",
            "  T* const mats = sink.row + SCENE_N_SCALARS;",
            "  const T gout[1] = {g};",
            f"  rm_sink_rows<T, {sizes[L]}, 1, {bf16}>(sink, {a[L]}, gout, "
            f"{dw[L]}, 1, 0, {db[L]});",
        ]
        if L == 0:
            return lines + [
                "  if (sink.active) {",
                "    for (int i = 0; i < 3; ++i) gin.v[i] = rm_operand<T, "
                f"{bf16}>(rm_operand<T, {bf16}>(__ldg({m[0]} + i)) * g);",
                "  }",
                "  return gin;", "}", ""]
        if L > 1:
            gw = max(sizes[1:L])
            lines.append(f"  T ga[{gw}];" + (f" T gb[{gw}];" if L > 2 else ""))
        gcur = None
        for layer in range(L, 0, -1):
            gnext = "gin.v" if layer == 1 else ("gb" if gcur == "ga" else "ga")
            scale = str(sine and layer == 1).lower()
            lines.append("  if (sink.active) {")
            if layer == L:
                lines.append(f"    rm_mlp_delta_out<T, {sizes[layer]}, {bf16}, "
                             f"{scale}>({m[L]}, g, {s[layer]}, w0);")
            else:
                lines.append(f"    rm_mlp_delta<T, {sizes[layer]}, {scale}>("
                             f"{gcur}, {s[layer]}, w0);")
            if layer > 1:
                lines.append(f"    for (int i = 0; i < {sizes[layer - 1]}; "
                             f"++i) {gnext}[i] = static_cast<T>(0);")
            lines.append("  }")
            lines.append(
                f"  rm_mlp_vjp_dense<T, {sizes[layer - 1]}, {sizes[layer]}, "
                f"{bf16}>({m[layer - 1]}, {a[layer - 1]}, {s[layer]}, "
                f"{gnext}, sink, {dw[layer - 1]}, {db[layer - 1]});")
            gcur = gnext
        return lines + ["  return gin;", "}", ""]

    def cuda_source(self) -> str:
        """Backend (a): the ``scene_sdf`` device function and its VJP
        ``scene_sdf_vjp``; C++ for nvcc. ``M`` is the packed matrix buffer
        (unused by analytic scenes). With neural leaves the VJP also takes
        the block's matrix sink (neural.cuh), accumulates only the
        :attr:`acc_scalars` in ``gP`` and adds nothing where the sink says
        the thread is inactive."""
        n, n_all = self.n_primal, len(self.ops)
        names = ["x", "y", "z"] + [f"v{i}" for i in range(3, n)]
        acc = {k: slot for slot, k in enumerate(self.acc_scalars)}
        lines = [
            "// Generated by ray_marching_tpu_torch/scene/codegen.py from",
            f"// {self.node!r}",
            "#pragma once",
            *(["#define SCENE_TC 1"] if self.tc else []),
            f"constexpr int SCENE_N_SCALARS = {len(self.scalar_offsets)};",
            f"constexpr int SCENE_N_MLP = {len(self.mlps)};",
            f"constexpr int SCENE_N_ACC = {len(self.acc_scalars)};",
            f"constexpr int SCENE_MAT_SIZE = {self.mat_size};",
            "// Compact scalar index of each per-thread accumulator.",
            "static __device__ const int SCENE_ACC_SCALAR["
            f"{max(1, len(self.acc_scalars))}] = {{"
            + ", ".join(map(str, self.acc_scalars or [0])) + "};",
            "",
        ]
        if self.mlps:
            lines += ['#include "neural.cuh"', ""]
            for k, leaf in enumerate(self.mlps):
                lines += self._mlp_source(k, leaf)
                if k in self.tc:
                    lines += self._mlp_tc_source(k, leaf)
                if self._keeps(k):
                    lines += self._mlp_keep_source(k, leaf)
                lines += self._mlp_vjp_source(k, leaf)
        lines += [
            ("template <typename T, bool TC = false>" if self.tc
             else "template <typename T>"),
            "__device__ __forceinline__ T scene_sdf(const T* __restrict__ P,"
            " const T* __restrict__ M, T x, T y, T z) {",
            *self._emit(names, 3, n),
            f"  return {names[self.out]};",
            "}",
            "",
            "// Vector-Jacobian product: returns d, writes the cotangent of",
            "// (x, y, z) for the cotangent g of d, and adds the parameter",
            "// cotangents to gP (SCENE_N_ACC values, layout order).",
            ("template <typename T, bool TC = false>" if self.tc
             else "template <typename T>"),
            "__device__ __forceinline__ T scene_sdf_vjp(const T* __restrict__"
            " P, const T* __restrict__ M, T x, T y, T z, T g, T& gx, T& gy,"
            " T& gz, T* gP" + (", const RmSink<T>& sink" if self.mlps else "")
            + ") {",
        ]
        # Primal values are w*, adjoint temporaries a*.
        names = (["x", "y", "z"] + [f"w{i}" for i in range(3, n)] + ["g"]
                 + [f"a{i}" for i in range(n + 1, n_all)])
        vjp = bool(self.mlps)
        for k, leaf in enumerate(self.mlps):
            if k in self.tc:
                lines.append(f"  alignas(16) T keep{k}[TC ? {leaf.sizes[2]}"
                             f" : {self._keep_offsets(leaf)[-1]}];")
            elif self._keeps(k):
                lines.append(f"  T keep{k}[{self._keep_offsets(leaf)[-1]}];")
        lines += (self._emit(names, 3, n, vjp, tape=True)
                  + self._emit(names, n + 1, n_all, vjp))
        for out, a in zip(("gx", "gy", "gz"), self.adj_xyz):
            lines.append(f"  {out} = "
                         f"{'static_cast<T>(0)' if a is None else names[a]};")
        guard = "if (sink.active) " if self.mlps else ""
        for k, a in self.adj_params:
            lines.append(f"  {guard}gP[{acc[k]}] = gP[{acc[k]}] + {names[a]};")
        lines += [f"  return {names[self.out]};", "}", ""]
        if self.pruned:
            lines += self._fwd_source()
        return "\n".join(lines)

    def _fwd_source(self) -> List[str]:
        """The short-circuit's C++ (module doc): ``SceneBounds<T>`` and its
        prologue ``scene_bounds``, and ``scene_sdf_fwd``, which reads them
        from ``B``."""
        bf, f = self._bounds, self._fwd
        n = len(self._bound_ids)
        bnames = ["x", "y", "z"] + [f"b{i}" for i in range(3, bf.n_primal)]
        names = ["x", "y", "z"] + [f"v{i}" for i in range(3, f.n_primal)]
        return [
            "// The union short-circuit: each guarded child's bounding sphere",
            "// (cx, cy, cz, R) from the parameters, once per thread, and the",
            "// SDF that skips a guarded child where lb > d.",
            "#define SCENE_PRUNE 1",
            f"constexpr int SCENE_N_BOUNDS = {n // 4};",
            "template <typename T>",
            "struct SceneBounds {",
            f"  T v[{n}];",
            "};",
            "",
            "template <typename T>",
            "__device__ __forceinline__ SceneBounds<T> scene_bounds(const T* "
            "__restrict__ P) {",
            *self._emit(bnames, 3, bf.n_primal, form=bf),
            "  SceneBounds<T> B;",
            *(f"  B.v[{j}] = {bnames[i]};"
              for j, i in enumerate(self._bound_ids)),
            "  return B;",
            "}",
            "",
            ("template <typename T, bool TC = false>" if self.tc
             else "template <typename T>"),
            "__device__ __forceinline__ T scene_sdf_fwd(const T* __restrict__ "
            "P, const T* __restrict__ M, const SceneBounds<T>& B, T x, T y, "
            "T z) {",
            *self._emit(names, 3, f.n_primal, form=f),
            f"  return {names[f.out]};",
            "}",
            "",
        ]

    def op_counts(self) -> Dict[str, int]:
        """Ray-dependent ops of one SDF evaluation, by class (a loop's body
        counted once per trip)."""
        ops, dep_of, n_primal = self._flat
        counts = dict.fromkeys(COUNT_CLASSES, 0)
        for op, dep in zip(ops[3:n_primal], dep_of[3:n_primal]):
            if op[0] == "mlp":
                for k, v in _mlp_op_counts(self.mlps[op[1]]).items():
                    counts[k] += v
            elif dep and op[0] in _OPS:
                counts[_OPS[op[0]][2]] += 1
        return counts

    @functools.cached_property
    def ops_per_eval(self) -> int:
        """Ray-dependent ops of one SDF evaluation (cached: the kernel
        wrappers read it at every launch, ``render_kernel.uses_refill``,
        and counting walks the unrolled program)."""
        return sum(self.op_counts().values())

    @property
    def vjp_ops_per_eval(self) -> int:
        """Ops of one ``scene_sdf_vjp``: the primal evaluation, every
        adjoint op (an MLP's VJP by :func:`_mlp_vjp_op_count`; a loop's
        adjoint once per trip), and one add per parameter scalar it
        accumulates. The recompute of a loop's body in its reverse loop is
        not counted (:attr:`vjp_recompute_ops`)."""
        ops, _, n_primal = self._flat
        adjoint = sum(1 for op in ops[n_primal + 1:] if op[0] in _OPS)
        adjoint += sum(_mlp_vjp_op_count(self.mlps[op[1]])
                       for op in ops[n_primal + 1:] if op[0] == "mlp_vjp")
        return self.ops_per_eval + adjoint + len(self.adj_params)

    @property
    def guard_ops(self) -> Tuple[Tuple[int, int], ...]:
        """Per guard, in slot order: the ray-dependent ops of its own test
        (``lb`` and the compare) and those its region holds (the child and
        the vmin, which a skip saves), by :meth:`op_counts`' convention.
        :attr:`ops_per_eval` counts the unpruned SDF; an evaluation of
        ``scene_sdf_fwd`` costs it plus each reached guard's test, less each
        skipped region."""
        f = self._fwd
        if f is None:
            return ()

        def count(ids):
            return sum(1 for i in ids if f.dep[i] and f.ops[i][0] in _OPS)

        out = []
        for g in f.guards:
            test = count(range(g.test, g.lb + 1)) + 1
            out.append((test, count(range(g.begin + 1, g.m + 1))))
        return tuple(out)

    @property
    def vjp_recompute_ops(self) -> int:
        """Ray-dependent ops that ``scene_sdf_vjp`` runs beyond
        :attr:`vjp_ops_per_eval`: each loop's body once more per trip, in
        its reverse loop."""
        return sum(lp.n * sum(1 for i in lp.body if self.ray_dependent[i]
                              and self.ops[i][0] in _OPS)
                   for lp in self.loops)
