"""The port's per-thread (SIMT) kernels on one card: what their code holds,
the Mandelbulb's digests, and the parent commit's kernels against this
checkout's, built side by side and timed in turns.

    python tools/torch_simt_variants.py sass [--package-root DIR]
    python tools/torch_simt_variants.py digest [--package-root DIR]
    python tools/torch_simt_variants.py host [--package-root DIR]
    python tools/torch_simt_variants.py variants --parent DIR \
        [--rows ROW,...] [--builds BUILD,...] [--rounds N]

``sass`` builds the libraries of test_scene2 and the Mandelbulb and the SASS
probes of ``chip_smoke.py`` (one SDF evaluation, one SDF VJP per thread) and
prints, per scene, ``chip_smoke.sass_report`` (SASS instructions per
evaluation and per VJP by class, code bytes of the serving forward's and
the march's loops and of the history backward's sweep, the slow-path calls
of the IEEE division and square root, local-memory accesses), every f32 and
f64 kernel's ptxas report (registers, stack, spill stores), and the bulb's
lane efficiency at its serving configuration with one thread per ray
(``chip_smoke.lane_efficiency``, from the training forward's live-step
plane), for the forward's rays and for the march's.

``digest`` prints ``chip_smoke.bulb_planes_digest`` (the bulb's f32 serving
forward and march planes at 1440×900) and ``bulb_backward_digest`` (its f32
backward's cotangents at the training configuration) as the package under
``--package-root`` computes them, so that the pinned
``chip_smoke.BULB_PLANES_DIGEST`` and ``BULB_BACKWARD_DIGEST`` can be
checked against another commit unpacked there (``git archive <commit>
ray_marching_tpu_torch | tar -x -C DIR``, in a directory ``.gitignore``
lists, such as ``_archive/``).

``host`` reads the host's share of the bulb's modular frame in a process
that holds nothing but its renderer: per march call on one row of the
frame's rays, the host's time (:func:`host_ms`), the device's
(``chip_smoke.kernel_ms``) and the latency of a call waited for; the host's
time of the library entry alone (one thread per ray; with a used slot
counter, which ends the refill kernel at once) and of the counter's
allocation; the frame by CUDA events and by the host clock, with Python's
garbage collector on and off, and the collections per frame. Run it for the parent's package and this one in
turns (``--package-root``).

``variants`` times the per-thread rows of PERF.md §6 for the package under
``--parent`` (the parent commit) and for this checkout with each build of
:data:`VARIANTS` (its own sources as they are, ``--fmad=true`` in place of
``--fmad=false``, and patched copies that undo one design choice each; a
variant may time only the rows it changes; ``--builds`` and ``--rows``
narrow both). All
builds are made first, one process each, all started together. Then four
processes time every row, in turns: the parent; this checkout's builds
there and back; the same again; the parent (``--rounds`` times). The rows:
the analytic serving
forward (1; at tau = 0 and 1e-3), with history, its backward with history
and recompute (2), the march-only backward, two levels (3), the march (4;
at tau = 0 and 1e-3), and the bulb's serving forward (1b; at tau = 1e-4
and 0), serving frame, forward with history, backward with history and
recompute (2b), march-only (2b′), two levels (3b), march (4b; serving, and
the training configuration at tau = 0; the host's time per march call),
modular frame and training step; the w256 field's per-thread march at tau
= 1e-3 in f32 and f64 (4n); test_scene2 with the union short-circuit, its
backward with history and recompute (2p) and two levels (3p); the w256
field's backward on the tensor cores at 512², 24 steps: history,
recompute, march-only and two levels (2n, 2n′, 3n). Every backward row
also gives the sha256 of its cotangents (which must agree across builds
and turns) and the device memory one call allocates at its peak. The fmad
build also gives its parity cost against the plain version: the share of
converged rays outside ``TOL_F32`` and the largest error of the forward
planes, and of the backward's ray cotangents (the share outside
``TOL_BWD`` of the ray's own largest cotangent), for test_scene2 and the
bulb. The default build stays ``--fmad=false``. Each build's ptxas report
is printed; readings go under ``--out``; the last line is a JSON object
with every reading.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: The nvcc flag of the fmad build, in place of --fmad=false.
FMAD_FLAGS = "--fmad=true"
#: The march rows, which the march's variants time: the analytic and bulb
#: marches, the w256 field's per-thread march at tau = 1e-3 (f32 on the
#: per-thread route, f64) and the host's time per march call.
MARCH_ROWS = ("4 march", "4 march tau 1e-3", "4b march", "4b march tau 0",
              "4n march f32 thread tau 1e-3", "4n march f64 tau 1e-3",
              "4b march wrapper host")
def _indent(text: str, by: int = 2) -> str:
    """``text`` with ``by`` more spaces before each non-empty line."""
    return "".join(" " * by + line if line.strip() else line
                   for line in text.splitlines(keepends=True))


#: This checkout's builds beside its own: name -> (replacements (exact
#: text, new text, count of matches) per kernel source, FMA contraction,
#: attributes of ops/render_kernel.py to set, the rows to time (all when
#: absent)).
VARIANTS = {
    "change": ({}, False),
    "fmad": ({}, True),
    # The bulb's serving forward with one thread per ray (no lane refill).
    "no-refill": ({}, False, {"REFILL_MIN_OPS": 1 << 30}),
    # The reverse sweep without the history prefetch.
    "no-prefetch": ({"render_bwd.cu": [(
        "constexpr bool BWD_PREFETCH = true;",
        "constexpr bool BWD_PREFETCH = false;", 1)]}, False),
    # The per-thread backward's launch bounds at five blocks an SM (96
    # registers) in place of four (128).
    "min-blocks-5": ({"render_bwd.cu": [(
        "constexpr int BWD_MIN_BLOCKS = 4;",
        "constexpr int BWD_MIN_BLOCKS = 5;", 1)]}, False),
    # The march kernels' SDF loop rolled (both kernels share the define).
    "march-refill-unroll-1": ({"march.cu": [(
        "#define RM_SDF_LOOP_UNROLL 5", "#define RM_SDF_LOOP_UNROLL 1",
        1)]}, False, {}, MARCH_ROWS),
    # The march with one thread per ray everywhere (no lane refill).
    "march-no-refill": ({}, False, {"REFILL_MIN_OPS": 1 << 30}, MARCH_ROWS),
    # Lane refill for every SDF at tau > 0 (the analytic march too).
    "march-refill-all": ({}, False, {"REFILL_MIN_OPS": 0}, MARCH_ROWS),
    # A frozen ray evaluates its terminal distance once more (the parent's
    # loop kernel; the refill kernel's frozen rays take a terminal pass).
    "march-no-freeze-reuse": ({"march.cu": [
        ("    } else {\n      store_march<T>(out, plane, i, x, y, z, d);\n"
         "      i = -1;\n    }\n", "    } else {\n      k = steps;\n    }\n",
         1),
        ("  if (t != static_cast<T>(0)) {\n    march_kernel<T, true>",
         "  if (false) {\n    march_kernel<T, true>", 1)]}, False, {},
        MARCH_ROWS),
    # The backward's tail with its offsets and cotangents chosen by selects
    # (registers) in place of the local arrays (its stack frame).
    # The backward's loop over ray blocks on 32-bit indices (the
    # persistent grid's loop-carried values in fewer registers).
    "bwd-int-blk": ({"render_bwd.cu": [
        ("  for (long long blk = blockIdx.x; blk < n_blocks;\n"
         "       blk += OWN ? gridDim.x : n_blocks) {",
         "  for (int blk = blockIdx.x; blk < (int)n_blocks;\n"
         "       blk += OWN ? (int)gridDim.x : (int)n_blocks) {", 1),
        ("    const long long i = blk * BWD_BLOCK + threadIdx.x;",
         "    const long long i = (long long)blk * BWD_BLOCK + threadIdx.x;",
         1)]}, False),
    # The per-thread f32 instantiations that march into a slot at the
    # history path's four blocks an SM for every scene (101-103 registers
    # on test_scene2), where the build gives a scene without a rolled loop
    # five (render_kernel.scene_flags).
    "bwd-own-min4": ({"render_bwd.cu": [
        ("constexpr int BWD_OWN_MIN_BLOCKS = RM_BWD_OWN_MIN_BLOCKS;",
         "constexpr int BWD_OWN_MIN_BLOCKS = BWD_MIN_BLOCKS;", 1)]}, False),
    # The two-level instantiation at the marching ones' blocks an SM too.
    "bwd-2l-own-min": ({"render_bwd.cu": [
        ("               : (OWN && !TWO_LEVEL && sizeof(T) == 4) ? "
         "BWD_OWN_MIN_BLOCKS",
         "               : (OWN && sizeof(T) == 4) ? BWD_OWN_MIN_BLOCKS", 1)]},
        False),
    # ... and at five for every scene, the bulb's rolled loop included (its
    # VJP then spills).
    "bwd-own-min5": ({"render_bwd.cu": [
        ("constexpr int BWD_OWN_MIN_BLOCKS = RM_BWD_OWN_MIN_BLOCKS;",
         "constexpr int BWD_OWN_MIN_BLOCKS = 5;", 1)]}, False),
    # (Written at the tail's indentation before the kernel's loop over ray
    # blocks, _indent adds the loop's level.)
    "tail-selects": ({"render_bwd.cu": [(_indent(old), _indent(new), n)
                                         for old, new, n in [
        ("      T ox[5], oy[5], oz[5], gf[5];\n", "", 1),
        ("        ox[k] = c.off[k][0];\n"
         "        oy[k] = c.off[k][1];\n"
         "        oz[k] = c.off[k][2];\n", "", 1),
        ("          const T v = march_sdf<T, true>(a.P, a.M, x + ox[k], "
         "y + oy[k],\n"
         "                                         z + oz[k]);\n",
         "          const T v = march_sdf<T, true>(a.P, a.M, x + c.off[k][0],\n"
         "                                         y + c.off[k][1], "
         "z + c.off[k][2]);\n", 1),
        ("                      : scene_sdf<T>(a.P, a.M, x + ox[k], y + oy[k],\n"
         "                                     z + oz[k]);\n",
         "                      : scene_sdf<T>(a.P, a.M, x + c.off[k][0],\n"
         "                                     y + c.off[k][1], "
         "z + c.off[k][2]);\n", 1),
        ("      ox[4] = zero;\n      oy[4] = zero;\n      oz[4] = zero;\n", "",
         1),
        ("      gf[0] = gmean - (gd1 + gd2 + gd3);\n"
         "      gf[1] = gmean + gd1;\n"
         "      gf[2] = gmean + gd2;\n"
         "      gf[3] = gmean + gd3;\n"
         "      gf[4] = a.g[3 * plane + i] + glap;\n",
         "      const T gf0 = gmean - (gd1 + gd2 + gd3);\n"
         "      const T gf1 = gmean + gd1;\n"
         "      const T gf2 = gmean + gd2;\n"
         "      const T gf3 = gmean + gd3;\n"
         "      const T gf4 = a.g[3 * plane + i] + glap;\n", 1),
        ("        sdf_vjp<T, TC>(a.P, a.M, x + ox[k], y + oy[k], z + oz[k], "
         "gf[k], sx,\n"
         "                       sy, sz, gP, sink);\n",
         "        const T ox = rm_pick5(k, c.off[0][0], c.off[1][0], "
         "c.off[2][0],\n"
         "                              c.off[3][0], zero);\n"
         "        const T oy = rm_pick5(k, c.off[0][1], c.off[1][1], "
         "c.off[2][1],\n"
         "                              c.off[3][1], zero);\n"
         "        const T oz = rm_pick5(k, c.off[0][2], c.off[1][2], "
         "c.off[2][2],\n"
         "                              c.off[3][2], zero);\n"
         "        sdf_vjp<T, TC>(a.P, a.M, x + ox, y + oy, z + oz,\n"
         "                       rm_pick5(k, gf0, gf1, gf2, gf3, gf4), sx, "
         "sy, sz, gP,\n"
         "                       sink);\n", 1)]]}, False),
}
#: The rows: name -> (scene, repetitions). "4b march wrapper host" is the
#: host's time per call of the march's wrapper on one row of the bulb's
#: modular rays (host clock, the launches queued, not waited for).
ROWS = {
    "1 forward": ("analytic", 30),
    "1 forward tau 1e-3": ("analytic", 30),
    "1 forward with history": ("analytic", 20),
    "2 backward history": ("analytic", 10),
    "2 backward recompute": ("analytic", 10),
    "2 march-only": ("analytic", 10),
    "3 two-level": ("analytic", 10),
    "4 march": ("analytic", 30),
    "4 march tau 1e-3": ("analytic", 30),
    "1b forward": ("bulb", 10),
    "1b forward tau 0": ("bulb", 5),
    "1b serving frame": ("bulb", 10),
    "bulb forward with history": ("bulb", 5),
    "2b backward history": ("bulb", 3),
    "2b backward recompute": ("bulb", 3),
    "2b' march-only": ("bulb", 3),
    "3b two-level": ("bulb", 3),
    "4b march": ("bulb", 10),
    "4b march tau 0": ("bulb", 10),
    "4n march f32 thread tau 1e-3": ("neural", 3),
    "4n march f64 tau 1e-3": ("neural", 2),
    "4b march wrapper host": ("bulb", 200),
    "bulb modular frame": ("bulb", 20),
    "bulb training step": ("bulb", 5),
    "2p backward history": ("pruned", 10),
    "2p backward recompute": ("pruned", 10),
    "3p two-level": ("pruned", 10),
    "2n backward history tc": ("neural", 2),
    "2n backward recompute tc": ("neural", 2),
    "2n' march-only tc": ("neural", 2),
    "3n two-level tc": ("neural", 2),
}
#: The backward rows: each turn also records the sha256 of their
#: cotangents and the device memory one call allocates at its peak.
BACKWARD_ROWS = tuple(r for r in ROWS if r.startswith(("2", "3")))


def load_smoke():
    """chip_smoke.py of this checkout, as a module (its kernel-side imports
    resolve through sys.path, so to the package under --package-root)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def set_fmad(rk, fmad: bool) -> None:
    """Build with --fmad=true instead of --fmad=false (the flags are part of
    the build hash, so the two builds live side by side)."""
    if fmad:
        rk.NVCC_FLAGS = tuple(FMAD_FLAGS if f == "--fmad=false" else f
                              for f in rk.NVCC_FLAGS)


def scenes(cs):
    """The two scenes' renderers: test_scene2 at 1080p (32 steps) and the
    bulb at 1440×900 (serving: 64 steps, tau 1e-4; training: 24, tau 0)."""
    import torch

    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.render.pipeline import Renderer
    from ray_marching_tpu_torch.scene import registry

    return {
        "analytic": FastRenderer(registry.make_scene("test_scene2"),
                                 cs.config(1920, 1080), dtype=torch.float32),
        "analytic modular": Renderer(registry.make_scene("test_scene2"),
                                     cs.config(1920, 1080, use_pallas=True),
                                     dtype=torch.float32),
        "bulb": cs.bulb_renderer(FastRenderer, cs.BULB_W, cs.BULB_H,
                                 torch.float32),
        "bulb modular": cs.bulb_renderer(Renderer, cs.BULB_W, cs.BULB_H,
                                         torch.float32, use_pallas=True),
        "bulb training": cs.bulb_renderer(
            FastRenderer, cs.BULB_W, cs.BULB_H, torch.float32,
            steps=cs.BULB_TRAIN_MARCH, tau=0.0),
    }


def run_sass() -> dict:
    cs = load_smoke()
    from ray_marching_tpu_torch.ops import render_kernel as rk

    card = cs.card_line()
    print(card, flush=True)
    r = scenes(cs)
    progs = {"test_scene2": r["analytic"].program, "mandelbulb":
             r["bulb"].program}
    probes = cs.start_sass_probes(progs)
    rk.build_kernels(progs.values())
    out = {"card": card}
    for label, prog in progs.items():
        log = rk.BUILD_LOG.get(rk.kernel_key(prog), "")
        ptx = cs.bulb_ptxas(log)
        print(f"ptxas ({label}): " + "; ".join(
            f"{e} {n} registers, {f} B stack, {sp} B spill stores"
            for e, n, f, sp in ptx), flush=True)
        out[label] = {"sass": cs.sass_report(label, prog, probes[label]),
                      "ptxas": ptx, "ops_per_eval": prog.ops_per_eval,
                      "vjp_ops_per_eval": prog.vjp_ops_per_eval}
    flat, rays7 = cs.main_rays(r["bulb"], cs.BENCH_Q, cs.BENCH_T)
    _, ex = rk.march_forward(progs["mandelbulb"], flat, rays7, cs.BULB_STEPS,
                             cs.BULB_TAU, 5e-2, log_hist=True)
    valid = rays7[6] > 0.5
    eff = cs.lane_efficiency(ex["nlive"], valid, cs.BULB_STEPS)
    mean = float(ex["nlive"][valid].double().mean())
    print(f"bulb lane efficiency ({cs.BULB_W}x{cs.BULB_H}, {cs.BULB_STEPS} "
          f"steps, tau {cs.BULB_TAU:g}; mean live steps {mean:.3f}): march "
          f"{eff[0]:.4f}, with the 5 tail evaluations {eff[1]:.4f}",
          flush=True)
    out["mandelbulb"]["lane_efficiency"] = eff
    out["mandelbulb"]["mean_live_steps"] = mean
    m_flat, m_rays7 = cs.modular_rays(r["bulb modular"], cs.BENCH_Q,
                                      cs.BENCH_T)
    _, ex = rk.march_forward(progs["mandelbulb"], m_flat, m_rays7,
                             cs.BULB_STEPS, cs.BULB_TAU, 5e-2, log_hist=True)
    eff = cs.lane_efficiency(ex["nlive"], m_rays7[6] > 0.5, cs.BULB_STEPS,
                             tail=1)
    print(f"bulb march lane efficiency (modular rays, one thread per ray): "
          f"{eff[0]:.4f}, with the terminal evaluation {eff[1]:.4f}",
          flush=True)
    out["mandelbulb"]["march_lane_efficiency"] = eff
    return out


def run_digest() -> dict:
    import torch

    cs = load_smoke()
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.ops.params import split_params_padded

    r = scenes(cs)
    flat, rays7 = cs.main_rays(r["bulb"], cs.BENCH_Q, cs.BENCH_T)
    m_flat, m_rays7 = cs.modular_rays(r["bulb modular"], cs.BENCH_Q,
                                      cs.BENCH_T)
    digest = cs.bulb_planes_digest(r["bulb"].program, flat, rays7, m_flat,
                                   m_rays7)
    start, _, _ = split_params_padded(
        cs.with_scale(r["bulb"].init_params, cs.BULB_SCALE0), torch.float32,
        r["bulb"].device)
    bwd = cs.bulb_backward_digest(r["bulb"].program, start, rays7)
    package = str(Path(rk.__file__).resolve().parents[2])
    print(f"package {package}: bulb planes digest {digest} (pinned "
          f"{cs.BULB_PLANES_DIGEST}: {digest == cs.BULB_PLANES_DIGEST}); "
          f"bulb backward digest {bwd} (pinned {cs.BULB_BACKWARD_DIGEST}: "
          f"{bwd == cs.BULB_BACKWARD_DIGEST})", flush=True)
    return {"package": package, "digest": digest, "backward_digest": bwd,
            "card": cs.card_line()}


def run_host(readings=5, calls=200) -> dict:
    import gc

    import torch

    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.render.pipeline import Renderer

    cs = load_smoke()
    r = cs.bulb_renderer(Renderer, cs.BULB_W, cs.BULB_H, torch.float32,
                         use_pallas=True)
    flat, rays7 = cs.modular_rays(r, cs.BENCH_Q, cs.BENCH_T)
    one_row = rays7[:, :1].contiguous()
    lib_fn = rk._load(r.program).rm_march_f32
    dst = torch.empty((4, 1, rk.LANES), device=one_row.device)
    counter = torch.zeros(1, dtype=torch.int32, device=one_row.device)
    stream = torch.cuda.current_stream().cuda_stream

    def march_call():
        mk.march_planes(r.program, flat, one_row, cs.BULB_STEPS, cs.BULB_TAU)

    def launch(nxt):
        # The library entry alone, as the wrapper calls it (the parent's
        # takes no counter); a used counter ends the refill kernel at once.
        args = [flat.data_ptr(), None, one_row.data_ptr(), dst.data_ptr(),
                rk.LANES, cs.BULB_STEPS, cs.BULB_TAU]
        if len(lib_fn.argtypes) == 9:
            args.append(nxt)
        return lambda: lib_fn(*args, stream)

    def latency(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    def frame():
        with torch.no_grad():
            r.render(r.init_params, cs.BENCH_Q, cs.BENCH_T, mode=cs.BULB_MODE,
                     degree=2)

    out = {"card": cs.card_line(),
           "package": str(Path(mk.__file__).resolve().parents[2])}
    for collector in ("gc on", "gc off"):
        (gc.enable if collector == "gc on" else gc.disable)()
        res = out[collector] = {
            "march call host ms": [], "march call device ms": [],
            "march call latency ms": [], "launch host ms": [],
            "launch used counter host ms": [], "zeros host ms": [],
            "frame ms": [], "frame host ms": [],
            "collections per frame": []}
        for _ in range(readings):
            res["march call host ms"].append(host_ms(march_call, calls))
            res["march call device ms"].append(cs.kernel_ms(march_call,
                                                            calls))
            res["march call latency ms"].append(latency(march_call))
            res["launch host ms"].append(host_ms(launch(None), calls))
            res["launch used counter host ms"].append(
                host_ms(launch(counter.data_ptr()), calls))
            res["zeros host ms"].append(host_ms(
                lambda: torch.zeros(1, dtype=torch.int32,
                                    device=one_row.device), calls))
            res["frame ms"].append(cs.cuda_ms(frame, cs.BULB_FRAMES))
            before = [s["collections"] for s in gc.get_stats()]
            res["frame host ms"].append(host_ms(frame, cs.BULB_FRAMES))
            res["collections per frame"].append(
                [(s["collections"] - b) / (cs.BULB_FRAMES + 1)
                 for s, b in zip(gc.get_stats(), before)])
        print(f"{out['package']} {collector}: " + "; ".join(
            f"{k} " + ", ".join(f"{v:.4f}" if isinstance(v, float) else
                                str(v) for v in vals)
            for k, vals in res.items()), flush=True)
    gc.enable()
    return out


def variant_dir(name: str) -> Path:
    from ray_marching_tpu_torch.ops import render_kernel as rk

    return rk.BUILD_DIR / "simt_variants" / name / "csrc"


_DEFAULTS: dict = {}


def use_variant(name: str):
    """Point the kernel build at the variant's sources, flags and wrapper
    attributes (the parent's package: its own)."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    if not _DEFAULTS:
        _DEFAULTS.update(CSRC=rk.CSRC, NVCC_FLAGS=rk.NVCC_FLAGS,
                         REFILL_MIN_OPS=getattr(rk, "REFILL_MIN_OPS", None))
    for key, value in _DEFAULTS.items():
        setattr(rk, key, value)
    if name == "parent":
        return
    _, fmad, *rest = VARIANTS[name]
    rk.CSRC = variant_dir(name)
    set_fmad(rk, fmad)
    for key, value in (rest[0] if rest else {}).items():
        setattr(rk, key, value)


#: The rows and builds ``--rows`` and ``--builds`` select (None: all).
SELECTED: dict = {"rows": None, "builds": None}


def variant_rows(name: str):
    """The rows ``name`` times (the parent and the change: all), within
    ``--rows``."""
    rest = VARIANTS.get(name, ())[2:]
    rows = rest[1] if len(rest) > 1 else tuple(ROWS)
    chosen = SELECTED["rows"]
    return tuple(r for r in rows if chosen is None or r in chosen)


def builds():
    """This checkout's builds to time: :data:`VARIANTS`, within
    ``--builds`` ("change" always)."""
    chosen = SELECTED["builds"]
    return [n for n in VARIANTS
            if chosen is None or n == "change" or n in chosen]


def write_variant(name: str) -> None:
    """The patched copy of this checkout's kernel sources for ``name``."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    out = variant_dir(name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(rk.CSRC, out)
    for fname, reps in VARIANTS[name][0].items():
        path = out / fname
        text = path.read_text()
        for old, new, count in reps:
            if text.count(old) != count:
                raise SystemExit(f"variant {name}: {old!r} matched "
                                 f"{text.count(old)} times in {fname}")
            text = text.replace(old, new)
        path.write_text(text)


def build_one(name: str) -> None:
    """Build the libraries of the scenes ``name``'s rows use (a process of
    its own; the parent's under its --package-root)."""
    import torch

    from ray_marching_tpu_torch.ops import render_kernel as rk

    cs = load_smoke()
    use_variant(name)
    r = scenes(cs)
    labels = ["analytic", "bulb"]
    progs = [r["analytic"].program, r["bulb"].program]
    if any(ROWS[row][0] == "pruned" for row in variant_rows(name)):
        labels.append("pruned")
        progs.append(pruned_program())
    if any(ROWS[row][0] == "neural" for row in variant_rows(name)):
        labels.append("neural")
        progs.append(cs.neural_renderer(cs.NEURAL_RES,
                                        torch.float32)[0].program)
    rk.build_kernels(progs)
    out = {}
    for label, prog in zip(labels, progs):
        out[label] = [e for e in cs.bulb_ptxas(rk.BUILD_LOG.get(
            rk.kernel_key(prog), "")) if "render_bwd" in e[0]
            or "render_fwd" in e[0] or "march" in e[0]]
    path = rk.BUILD_DIR / "simt_variants" / f"{name}.ptxas.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))


def pruned_program():
    """test_scene2 with the union short-circuit (rows 2p and 3p)."""
    from ray_marching_tpu_torch.scene import registry
    from ray_marching_tpu_torch.scene.codegen import SdfProgram

    return SdfProgram(registry.make_scene("test_scene2"), prune=True)


def digest_and_peak(fn):
    """sha256 of a backward's cotangents (flat, matrices, rays) and the
    device bytes one call allocates at its peak."""
    import hashlib

    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    flat, mats, rays = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    h = hashlib.sha256()
    for t in (flat, *mats, rays):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest(), peak


def host_ms(fn, reps):
    """The host's time per call over ``reps`` calls, their launches queued
    and waited for only after the clock stops."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


class Rows:
    """The inputs of every row for one build, and the calls they time."""

    def __init__(self, cs):
        import numpy as np
        import torch

        from ray_marching_tpu_torch.ops.params import split_params_padded

        self.cs = cs
        self.r = r = scenes(cs)
        self.flat, self.rays7 = cs.main_rays(r["analytic"], cs.BENCH_Q,
                                             cs.BENCH_T)
        self.m_flat, self.m_rays7 = cs.modular_rays(
            r["analytic modular"], cs.BENCH_Q, cs.BENCH_T)
        self.b_flat, self.b_rays7 = cs.main_rays(r["bulb"], cs.BENCH_Q,
                                                 cs.BENCH_T)
        self.bm_flat, self.bm_rays7 = cs.modular_rays(
            r["bulb modular"], cs.BENCH_Q, cs.BENCH_T)
        self.start = cs.with_scale(r["bulb"].init_params, cs.BULB_SCALE0)
        self.t_flat, _, _ = split_params_padded(self.start, torch.float32,
                                                r["bulb"].device)
        rng = np.random.default_rng(37)

        def cot(n, rays):
            return torch.as_tensor(rng.standard_normal(
                (n,) + tuple(rays.shape[1:])), dtype=torch.float32).to(
                    rays.device)

        self.g8, self.g4 = cot(8, self.rays7), cot(4, self.m_rays7)
        self.bg8, self.bg4 = cot(8, self.b_rays7), cot(4, self.bm_rays7)
        with torch.no_grad():
            self.target = r["bulb training"].render(
                r["bulb"].init_params, cs.BENCH_Q, cs.BENCH_T, mode=0,
                degree=2)
        self._neural = {}
        self.pruned = pruned_program()
        self.ng8 = self.ng4 = None

    def neural(self, dtype):
        """The w256 field's program, flat parameters, matrices and planes
        at its main configuration (512², the demo's pose), in ``dtype``."""
        if dtype not in self._neural:
            r, params = self.cs.neural_renderer(self.cs.NEURAL_RES, dtype)
            self._neural[dtype] = (r.program, *self.cs.neural_rays(r,
                                                                   params))
        return self._neural[dtype]

    def calls(self):
        """{row: (a call, repetitions, events around calls (True) or
        kernel_ms (False))}."""
        import numpy as np
        import torch

        from ray_marching_tpu_torch.ops import backward_kernel as bk
        from ray_marching_tpu_torch.ops import march_kernel as mk
        from ray_marching_tpu_torch.ops import render_kernel as rk

        cs, r = self.cs, self.r
        ap, bp = r["analytic"].program, r["bulb"].program
        steps, bsteps, tsteps = cs.STEPS, cs.BULB_STEPS, cs.BULB_TRAIN_MARCH
        _, ah = rk.march_forward(ap, self.flat, self.rays7, steps, 0.0, 5e-2,
                                 log_hist=True)
        _, bh = rk.march_forward(bp, self.t_flat, self.b_rays7, tsteps, 0.0,
                                 5e-2, log_hist=True)

        def bwd(prog, flat, rays, g, n, ex=None, **kw):
            if ex is not None:
                kw.update(hist=ex["hist"], nlive=ex["nlive"])
            return lambda: bk.fused_backward(prog, flat, rays, g, n, 0.0,
                                             5e-2, **kw)

        leaves = cs.leaf_params(self.start)
        opt = torch.optim.Adam(list(cs.trainable_leaves(
            leaves, ["c1/child/scale"]).values()), lr=1e-2)
        trainer = r["bulb training"]

        def train_step():
            opt.zero_grad(set_to_none=True)
            torch.mean((trainer.render(leaves, cs.BENCH_Q, cs.BENCH_T,
                                       mode=0, degree=2)
                        - self.target) ** 2).backward()
            opt.step()

        def frame(name="bulb"):
            with torch.no_grad():
                r[name].render(r[name].init_params, cs.BENCH_Q, cs.BENCH_T,
                               mode=cs.BULB_MODE, degree=2)

        def neural_march(dtype):
            def run():
                prog, flat, mats, rays = self.neural(dtype)
                return mk.march_forward(prog, flat, rays, cs.NEURAL_STEPS,
                                        1e-3, mats, route="thread")
            return run

        one_row = self.bm_rays7[:, :1].contiguous()
        f, a, b = self.flat, self.rays7, self.b_rays7
        pp = self.pruned
        _, ph = rk.march_forward(pp, f, a, steps, 0.0, 5e-2, log_hist=True)
        nsteps = cs.NEURAL_STEPS

        def neural_bwd(**kw):
            def run():
                prog, flat, mats, rays = self.neural(torch.float32)
                if self.ng8 is None:
                    rng = np.random.default_rng(39)
                    self.ng8, self.ng4 = (torch.as_tensor(
                        rng.standard_normal((n,) + tuple(rays.shape[1:])),
                        dtype=torch.float32).to(rays.device) for n in (8, 4))
                if kw.get("hist"):
                    _, ex = rk.march_forward(prog, flat, rays, nsteps, 0.0,
                                             5e-2, log_hist=True, mats=mats)
                    self._neural_hist = dict(hist=ex["hist"],
                                             nlive=ex["nlive"])
                    return lambda: bk.fused_backward(
                        prog, flat, rays, self.ng8, nsteps, 0.0, 5e-2,
                        mats=mats, **self._neural_hist)
                if kw.get("march_only"):
                    return lambda: bk.march_backward(
                        prog, flat, rays, self.ng4, nsteps, 0.0, mats=mats)
                return lambda: bk.fused_backward(
                    prog, flat, rays, self.ng8, nsteps, 0.0, 5e-2, mats=mats,
                    two_level=kw.get("two_level", False))
            return LazyCall(run)

        return {
            "1 forward": lambda: rk.fused_march_normals(ap, f, a, steps, 0.0,
                                                        5e-2),
            "1 forward tau 1e-3": lambda: rk.fused_march_normals(
                ap, f, a, steps, 1e-3, 5e-2),
            "1 forward with history": lambda: rk.march_forward(
                ap, f, a, steps, 0.0, 5e-2, log_hist=True),
            "2 backward history": bwd(ap, f, a, self.g8, steps, ah),
            "2 backward recompute": bwd(ap, f, a, self.g8, steps),
            "2 march-only": lambda: bk.march_backward(
                ap, self.m_flat, self.m_rays7, self.g4, steps, 0.0),
            "3 two-level": bwd(ap, f, a, self.g8, steps, two_level=True),
            "4 march": lambda: mk.march_planes(ap, self.m_flat, self.m_rays7,
                                               steps, 0.0),
            "4 march tau 1e-3": lambda: mk.march_planes(
                ap, self.m_flat, self.m_rays7, steps, 1e-3),
            "1b forward": lambda: rk.fused_march_normals(
                bp, self.b_flat, b, bsteps, cs.BULB_TAU, 5e-2),
            "1b forward tau 0": lambda: rk.fused_march_normals(
                bp, self.b_flat, b, bsteps, 0.0, 5e-2),
            "1b serving frame": frame,
            "bulb forward with history": lambda: rk.march_forward(
                bp, self.t_flat, b, tsteps, 0.0, 5e-2, log_hist=True),
            "2b backward history": bwd(bp, self.t_flat, b, self.bg8, tsteps,
                                       bh),
            "2b backward recompute": bwd(bp, self.t_flat, b, self.bg8,
                                         tsteps),
            "2b' march-only": lambda: bk.march_backward(
                bp, self.t_flat, self.bm_rays7, self.bg4, tsteps, 0.0),
            "3b two-level": bwd(bp, self.t_flat, b, self.bg8, tsteps,
                                two_level=True),
            "4b march": lambda: mk.march_planes(bp, self.bm_flat,
                                                self.bm_rays7, bsteps,
                                                cs.BULB_TAU),
            "4b march tau 0": lambda: mk.march_planes(
                bp, self.t_flat, self.bm_rays7, tsteps, 0.0),
            "4n march f32 thread tau 1e-3": neural_march(torch.float32),
            "4n march f64 tau 1e-3": neural_march(torch.float64),
            "4b march wrapper host": lambda: mk.march_planes(
                bp, self.bm_flat, one_row, bsteps, cs.BULB_TAU),
            "bulb modular frame": lambda: frame("bulb modular"),
            "bulb training step": train_step,
            "2p backward history": bwd(pp, f, a, self.g8, steps, ph),
            "2p backward recompute": bwd(pp, f, a, self.g8, steps),
            "3p two-level": bwd(pp, f, a, self.g8, steps, two_level=True),
            "2n backward history tc": neural_bwd(hist=True),
            "2n backward recompute tc": neural_bwd(),
            "2n' march-only tc": neural_bwd(march_only=True),
            "3n two-level tc": neural_bwd(two_level=True),
        }

    def time_all(self, label, rows, checks=None):
        """{row: ms}; with ``checks`` (a dict) also each backward row's
        sha256 and peak bytes into ``checks[row]``."""
        out = {}
        events = ("1b serving frame", "bulb modular frame",
                  "bulb training step")
        for name, fn in self.calls().items():
            if name not in rows:
                continue
            if isinstance(fn, LazyCall):
                fn = fn.resolve()
            if checks is not None and name in BACKWARD_ROWS:
                checks[name] = digest_and_peak(fn)
            reps = ROWS[name][1]
            if name == "4b march wrapper host":
                ms = host_ms(fn, reps)
            elif name in events:
                ms = self.cs.cuda_ms(fn, reps)
            else:
                ms = self.cs.kernel_ms(fn, reps)
            out[name] = ms
            print(f"{label}: {name} {ms:.4f} ms", flush=True)
        return out


class LazyCall:
    """A row's call whose inputs are made at its first use (the w256
    field's only for the turns that time it)."""

    def __init__(self, make):
        self.make, self.fn = make, None

    def resolve(self):
        if self.fn is None:
            self.fn = self.make()
        return self.fn


def parity(cs, rows: Rows) -> dict:
    """The fmad build's parity cost against the plain version: per scene,
    the forward planes (the share of converged rays outside TOL_F32 on
    some plane, the largest error per plane) and the backward with history
    (the share of converged rays whose 6 cotangents are not within TOL_BWD
    of the ray's own largest, and the largest such error)."""
    import numpy as np
    import torch

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    out = {}
    for label, prog, flat, rays, steps, tau, bsteps in (
            ("analytic", rows.r["analytic"].program, rows.flat, rows.rays7,
             cs.STEPS, 0.0, cs.STEPS),
            ("bulb", rows.r["bulb"].program, rows.b_flat, rows.b_rays7,
             cs.BULB_STEPS, cs.BULB_TAU, cs.BULB_TRAIN_MARCH)):
        got = rk.fused_march_normals(prog, flat, rays, steps, tau, 5e-2)
        want = rk.reference_march_normals(prog, flat, rays, steps, tau, 5e-2)
        conv = (rays[6] > 0.5) & (want[3].abs() < cs.CONVERGED)
        diff, outside = cs.plane_errors(got, want, conv, cs.TOL_F32)
        fwd = {"share_outside": float(outside[conv].float().mean()),
               "max_abs": dict(zip(cs.PLANES, diff))}
        b_flat = rows.t_flat if label == "bulb" else flat
        _, ex = rk.march_forward(prog, b_flat, rays, bsteps, 0.0, 5e-2,
                                 log_hist=True)
        g = torch.as_tensor(np.random.default_rng(38).standard_normal(
            (8,) + tuple(rays.shape[1:])), dtype=torch.float32).to(
                rays.device)
        kw = dict(hist=ex["hist"], nlive=ex["nlive"])
        k = bk.fused_backward(prog, b_flat, rays, g, bsteps, 0.0, 5e-2, **kw)
        p = bk.reference_backward(prog, b_flat, rays, g, bsteps, 0.0, 5e-2,
                                  **kw)
        out_k, _ = rk.march_forward(prog, b_flat, rays, bsteps, 0.0, 5e-2)
        bconv = (rays[6] > 0.5) & (out_k[3].abs() < cs.CONVERGED)
        kr, pr = k[2][:6], p[2][:6]
        scale = pr.abs().amax(dim=0)
        diff = (kr - pr).abs().amax(dim=0)
        rel = torch.where(scale > 0, diff / scale,
                          torch.where(diff > 0, torch.inf, 0.0))[bconv]
        rel = torch.where(torch.isnan(rel), torch.inf, rel)
        out[label] = {"forward": fwd, "backward": {
            "share_outside": float((rel > cs.TOL_BWD["f32"]).float().mean()),
            "max_rel": float(rel.max())}}
        print(f"fmad parity {label}: {out[label]}", flush=True)
    return out


def run_turn(names, label) -> dict:
    """Time every row for each build of ``names`` (this process's package),
    in order, then back; the fmad build's parity when it is one of them."""
    cs = load_smoke()
    rows = {}
    for name in names:
        use_variant(name)
        rows[name] = Rows(cs)
    result = {"card": cs.card_line(), "times": {}, "checks": {}}
    order = list(names) + list(reversed(names))
    for k, name in enumerate(order):
        use_variant(name)
        checks = result["checks"].setdefault(name, {}) if k == 0 else None
        result["times"].setdefault(name, []).append(
            rows[name].time_all(f"{label} {name} ({k})", variant_rows(name),
                                checks))
    if "fmad" in names:
        result["fmad_parity"] = parity(cs, rows["fmad"])
    return result


def run_variants(parent: Path, out: Path, rounds: int = 1) -> dict:
    """Build every build together, then time, ``rounds`` times: parent,
    this checkout's builds (there and back), this checkout's again,
    parent."""
    cs = load_smoke()
    card = cs.card_line()
    print(card, flush=True)
    out.mkdir(parents=True, exist_ok=True)
    for name in builds():
        write_variant(name)
    me = [sys.executable, __file__] + [
        a for key in ("rows", "builds") if SELECTED[key] is not None
        for a in (f"--{key}", ",".join(SELECTED[key]))]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(me + ["build", name]) for name in builds()]
    procs.append(subprocess.Popen(me + ["build", "parent", "--package-root",
                                        str(parent)]))
    try:
        for proc in procs:
            if proc.wait() != 0:
                raise SystemExit("a build failed")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    from ray_marching_tpu_torch.ops import render_kernel as rk

    ptxas = {}
    parent_dir = (parent / rk.BUILD_DIR.relative_to(ROOT) / "simt_variants")
    for path in sorted([*(rk.BUILD_DIR / "simt_variants").glob("*.ptxas.json"),
                        *parent_dir.glob("parent.ptxas.json")]):
        name = path.name.split(".")[0]
        ptxas[name] = json.loads(path.read_text())
        for label, entries in ptxas[name].items():
            print(f"ptxas {name} {label}: " + "; ".join(
                f"{e[:48]} {r}/{f}/{sp}" for e, r, f, sp in entries),
                flush=True)
    turns = []
    order = (("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)) * rounds
    for k, (who, root) in enumerate(order):
        path = out / f"turn{k}.json"
        cmd = me + ["turn", who, "--package-root", str(root), "--json",
                    str(path)]
        if subprocess.run(cmd).returncode != 0:
            raise SystemExit(f"turn {k} ({who}) failed")
        turns.append(json.loads(path.read_text()))
    times = {}
    for t in turns:
        for name, runs in t["times"].items():
            times.setdefault(name, []).extend(runs)
    summary, spread = {}, {}
    for name, runs in times.items():
        summary[name] = {row: sum(r[row] for r in runs) / len(runs)
                         for row in variant_rows(name)}
        spread[name] = {row: (min(r[row] for r in runs),
                              max(r[row] for r in runs))
                        for row in variant_rows(name)}
    for row in variant_rows("change"):
        print(f"{row}: " + ", ".join(
            f"{n} {summary[n][row]:.4f} [{spread[n][row][0]:.4f} … "
            f"{spread[n][row][1]:.4f}]" for n in summary
            if row in summary[n]) + " ms (change / parent "
            f"{summary['change'][row] / summary['parent'][row]:.4f})",
            flush=True)
    checks = {}
    for t in turns:
        for name, rows in t["checks"].items():
            for row, (digest, peak) in rows.items():
                checks.setdefault(row, {}).setdefault(name, []).append(
                    (digest, peak))
    for row, by_name in checks.items():
        digests = {d for runs in by_name.values() for d, _ in runs}
        print(f"{row}: sha256 {'equal' if len(digests) == 1 else 'DIFFER'} "
              "across builds and turns; peak bytes " + ", ".join(
                  f"{n} {max(p for _, p in runs)}"
                  for n, runs in by_name.items()), flush=True)
    return {"card": card, "mean_ms": summary, "min_max_ms": spread,
            "ptxas": ptxas, "checks": checks, "turns": turns}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("sass", "digest", "host",
                                         "variants", "build", "turn"))
    parser.add_argument("name", nargs="?",
                        help="build: the build; turn: parent or change")
    parser.add_argument("--package-root", default=str(ROOT),
                        help="the checkout whose ray_marching_tpu_torch runs")
    parser.add_argument("--parent", help="variants: the parent's checkout")
    parser.add_argument("--json", help="turn: where its readings go")
    parser.add_argument("--rows", help="comma-separated rows to time "
                        "(default: all)")
    parser.add_argument("--builds", help="comma-separated builds of "
                        "VARIANTS to time besides change (default: all)")
    parser.add_argument("--rounds", type=int, default=1,
                        help="variants: times to repeat the four turns")
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                             "simt_variants"),
                        help="variants: where the turns' readings go")
    args = parser.parse_args(argv)
    for key in ("rows", "builds"):
        value = getattr(args, key)
        if value is not None:
            SELECTED[key] = value.split(",")
            unknown = set(SELECTED[key]) - set(ROWS if key == "rows"
                                               else VARIANTS)
            if unknown:
                parser.error(f"unknown {key}: {sorted(unknown)}")
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_simt_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.mode == "build":
        build_one(args.name)
        return 0
    if args.mode == "turn":
        names = ["parent"] if args.name == "parent" else builds()
        Path(args.json).write_text(json.dumps(run_turn(names, args.name)))
        return 0
    if args.mode == "variants":
        result = run_variants(Path(args.parent).resolve(), Path(args.out),
                              args.rounds)
    else:
        result = {"sass": run_sass, "digest": run_digest,
                  "host": run_host}[args.mode]()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
