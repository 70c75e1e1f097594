"""Variants of the port's tensor-core CUDA sources, built and measured side
by side on one card, and the f64 neural digest of any checkout of the port.

    python tools/torch_tc_variants.py variants
    python tools/torch_tc_variants.py accuracy [--parent DIR]
    python tools/torch_tc_variants.py digest [--package-root DIR]

``variants`` copies ``ray_marching_tpu_torch/ops/csrc`` once per entry of
:data:`VARIANTS` (under the build directory, which ``.gitignore`` lists),
applies the entry's text replacements, builds every copy's libraries for
the w256 scene of ``chip_smoke.py`` (f32 and bf16 operands; one process per
copy, all started together) and then, per variant:

- holds the bf16-operand backward at 128² against its plain version and its
  control (``chip_smoke.neural_bf16_backward``: ``TOL_NEURAL_BWD_BF16``),
  and the bf16 serving forward at 128² against its plain version
  (``TOL_BF16``);
- holds the f32 backward at 512² against its plain version in its three
  modes (``chip_smoke.neural_backward_vs_plain``: ``TOL_NEURAL_BWD``);
- times the f32 and bf16 history backwards and the bf16 serving forward at
  512² (``chip_smoke.kernel_ms``), the variants in turns, twice;
- reads ptxas's registers, stack, spills and shared memory of the f32
  tensor-core history backward.

A variant that fails to build or fails a check is reported as failing; the
others go on. The last line is a JSON object with every reading.

``accuracy`` builds the f32 w256 library once per entry of
:data:`ACC_VARIANTS` (an f32 accumulation scheme per tensor-core product:
the primal hidden layer, the VJP's W1·δ2 and the sink h1ᵀ·δ2). ``neural.cuh``
ships one scheme per product written out (the primal's ``FRESH``, the VJP's
and the sink's ``BOTH``); :data:`ACC_SCHEMES_DIFF` makes all of them
selectable again in a variant's copy (``RM_ACC_*``), and the entry's
replacements then choose. With ``--parent DIR`` (a commit's package unpacked
under DIR, e.g. ``git archive HEAD~1 ray_marching_tpu_torch | tar -x -C
DIR``), once more from the parent's kernel sources; always once from this
checkout's sources as they are (``checkout``). For each it reads, on
the w256 field at 512² (24 steps, f32, tensor cores), the largest leaf
distance of three gradients from the plain march's in f64 (the frame's
mean square on converged pixels and on every pixel, and the training loss
against the frame of the plain route at weights 1.02x; chip_smoke.py's
``w256_witness`` losses), the training forward's history distance from
the plain march on converged rays, and then times in turns, twice, the
serving forward, the march, the history and two-level backwards and a
training step (all leaves, Adam). Readings go to
``chiprun_out/tc_variants/accuracy.json`` too.

``digest`` prints ``chip_smoke.neural_f64_digest`` (the f64 training
forward's history and the backward's cotangents at 128², per thread) as the
package under ``--package-root`` (default: this checkout) computes it, so
that the pinned ``chip_smoke.NEURAL_F64_DIGEST`` can be checked against
another commit unpacked there.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
#: A unified diff of neural.cuh that brings back the f32 accumulation
#: schemes behind the RM_ACC_PRIMAL / RM_ACC_VJP / RM_ACC_SINK selectors,
#: with the shipped choice selected (the same bits as the source).
ACC_SCHEMES_DIFF = ROOT / "tools" / "torch_tc_acc_schemes.diff"
FRESH = re.compile(r"constexpr bool FRESH = [^;]*;")
#: name -> replacements (a compiled pattern or an exact string, the text,
#: the count of matches it must have) in neural.cuh / render_bwd.cu.
VARIANTS = {
    # bf16 operands: fresh k-step accumulators in the backward's primal
    # (KEEP) only; serving keeps the mma's running sum.
    "fresh-keep-only": {"neural.cuh": [(FRESH, "constexpr bool FRESH = KEEP;",
                                        1)]},
    # ... and in every tensor-core evaluation, serving included.
    "fresh-everywhere": {"neural.cuh": [(FRESH, "constexpr bool FRESH = true;",
                                         1)]},
    # The backward's blocks (and so the sink's K) at 256 rays. The per-thread
    # SYNC entries' static staging is left at 128 rays so that the library
    # still builds: those entries are not valid in this variant and are not
    # launched; only the tensor-core ones are.
    "block-256": {
        "neural.cuh": [("constexpr int RM_SINK_THREADS = 128;",
                        "constexpr int RM_SINK_THREADS = 256;", 1),
                       ("const int mt = warp + 4 * q;",
                        "const int mt = warp + 8 * q;", 3)],
        "render_bwd.cu": [("constexpr int BWD_BLOCK = 128;",
                           "constexpr int BWD_BLOCK = 256;", 1),
                          ("__shared__ T sa[RM_SINK_THREADS * SW];",
                           "__shared__ T sa[128 * SW];", 1),
                          ("__shared__ T sd[RM_SINK_THREADS * SW];",
                           "__shared__ T sd[128 * SW];", 1)],
    },
}
#: name -> the f32 accumulation scheme of (rm_mlp_tc's hidden layer,
#: rm_mlp_tc_vjp's W1·δ2, its sink h1ᵀ·δ2): neural.cuh's RM_ACC_<scheme>.
ACC_VARIANTS = {
    "chain": ("CHAIN", "CHAIN", "CHAIN"),
    "fresh-primal": ("FRESH", "CHAIN", "CHAIN"),
    "fresh-vjp": ("CHAIN", "FRESH", "CHAIN"),
    "fresh-sink": ("CHAIN", "CHAIN", "FRESH"),
    "fresh2-primal": ("FRESH2", "CHAIN", "CHAIN"),
    "fresh-primal-both-vjp": ("FRESH", "BOTH", "CHAIN"),
    "fresh-primal-both-sink": ("FRESH", "CHAIN", "BOTH"),
    "fresh-primal-both-bwd": ("FRESH", "BOTH", "BOTH"),
    "fresh-primal-split-bwd": ("FRESH", "SPLIT", "SPLIT"),
    "split": ("SPLIT",) * 3,
    "fresh": ("FRESH",) * 3,
    "both": ("BOTH",) * 3,
}
ACC_PRODUCTS = ("PRIMAL", "VJP", "SINK")
for _name, _schemes in ACC_VARIANTS.items():
    VARIANTS["acc-" + _name] = {"neural.cuh": [
        (re.compile(rf"constexpr int RM_ACC_{prod} = RM_ACC_\w+;"),
         f"constexpr int RM_ACC_{prod} = RM_ACC_{scheme};", 1)
        for prod, scheme in zip(ACC_PRODUCTS, _schemes)]}
# The primal's fresh accumulation with B fragments loaded two n-tiles at a
# time instead of four (fewer tiles in flight: the forward's spills).
VARIANTS["acc-fresh-primal-g2"] = {"neural.cuh": [
    *VARIANTS["acc-fresh-primal"]["neural.cuh"],
    ("  constexpr int G = NT % 4 == 0 ? 4 : (NT % 2 == 0 ? 2 : 1);\n"
     "  // bf16: each k-step",
     "  constexpr int G = NT % 2 == 0 ? 2 : 1;\n  // bf16: each k-step", 1)]}
#: The f32 tensor-core history backward's mangled template arguments.
BWD_TC_ARGS = "IfLb0ELb0ELb0ELb1ELb0EE"


def load_smoke():
    """chip_smoke.py of this checkout, as a module (its kernel-side imports
    resolve through sys.path, so to the package under --package-root)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def variant_dir(name: str) -> Path:
    from ray_marching_tpu_torch.ops import render_kernel as rk

    return rk.BUILD_DIR / "variants" / name / "csrc"


def diff_hunks(diff: str):
    """(old, new) texts of each hunk of a unified diff of one file."""
    hunks = []
    for block in re.split(r"^@@[^\n]*\n", diff, flags=re.M)[1:]:
        old, new = [], []
        for line in block.splitlines(keepends=True):
            tag, body = line[:1], line[1:]
            if tag in (" ", "-"):
                old.append(body)
            if tag in (" ", "+"):
                new.append(body)
        hunks.append(("".join(old), "".join(new)))
    return hunks


def acc_schemes_source(text: str) -> str:
    """neural.cuh's text with :data:`ACC_SCHEMES_DIFF` applied (each hunk's
    old text must occur once)."""
    for old, new in diff_hunks(ACC_SCHEMES_DIFF.read_text()):
        if text.count(old) != 1:
            raise SystemExit(f"{ACC_SCHEMES_DIFF.name}: a hunk matched "
                             f"{text.count(old)} times in neural.cuh, "
                             f"expected 1 (regenerate it):\n{old[:400]}")
        text = text.replace(old, new)
    return text


def write_variant(name: str, source: Path | None = None) -> Path:
    """The patched copy of the kernel sources for ``name`` (``source``: a
    directory of kernel sources copied as they are)."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    out = variant_dir(name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(source or rk.CSRC, out)
    if name.startswith("acc-"):
        path = out / "neural.cuh"
        path.write_text(acc_schemes_source(path.read_text()))
    for fname, reps in ({} if source else VARIANTS[name]).items():
        path = out / fname
        text = path.read_text()
        for old, new, count in reps:
            if isinstance(old, re.Pattern):
                text, n = old.subn(new, text)
            else:
                n = text.count(old)
                text = text.replace(old, new)
            if n != count:
                raise SystemExit(f"variant {name}: {old!r} matched {n} times "
                                 f"in {fname}, expected {count}")
        path.write_text(text)
    return out


def programs(cs):
    from ray_marching_tpu_torch.scene.codegen import SdfProgram

    return {"f32": SdfProgram(cs.neural_scene()),
            "bf16": SdfProgram(cs.neural_scene("bfloat16"))}


def build_one(name: str, only_f32: bool = False) -> None:
    """Build the variant's libraries (run in a process of its own) and keep
    the f32 library's ptxas report beside its sources."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    cs = load_smoke()
    rk.CSRC = variant_dir(name)
    progs = programs(cs)
    rk.build_kernels([progs["f32"]] if only_f32 else list(progs.values()))
    (rk.CSRC.parent / "build_f32.log").write_text(
        rk.BUILD_LOG.get(rk.kernel_key(progs["f32"]), ""))


def build_all(names, only_f32=False) -> list:
    """Build the written variants ``names``, one process each, all started
    together; returns the names whose build failed."""
    t0 = time.perf_counter()
    extra = ["--only-f32"] if only_f32 else []
    procs = {name: subprocess.Popen([sys.executable, __file__, "build", name,
                                     *extra]) for name in names}
    failed = []
    try:
        for name, proc in procs.items():
            if proc.wait() != 0:
                print(f"variant {name}: build FAILED", flush=True)
                failed.append(name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return failed


def bind(cs, name: str):
    """The variant's programs, bound to its built libraries, and ptxas's
    (registers, stack, spill stores, static shared memory) of its f32
    tensor-core history backward."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    rk.CSRC = variant_dir(name)
    progs = programs(cs)
    for prog in progs.values():
        rk._load(prog)
    log = (rk.CSRC.parent / "build_f32.log").read_text()
    return progs, cs.ptxas_entry(log, "render_bwd_kernel", BWD_TC_ARGS)


def run_variants() -> dict:
    import torch

    cs = load_smoke()
    card = cs.card_line()
    print(card, flush=True)
    names = [n for n in VARIANTS if not n.startswith("acc-")]
    for name in names:
        write_variant(name)
    failed_builds = build_all(names)
    result = {"card": card, "failed_builds": failed_builds, "variants": {}}
    bound = {}
    for name in names:
        if name in failed_builds:
            continue
        bound[name], regs = bind(cs, name)
        result["variants"][name] = {"ptxas_bwd_tc": regs}
    small = cs.NEURAL_F64_RES
    main, params = cs.neural_renderer(cs.NEURAL_RES, torch.float32)
    flat, mats, rays7 = cs.neural_rays(main, params)
    rbf, pbf = cs.neural_renderer(small, torch.float32,
                                  scene=cs.neural_scene("bfloat16"))
    s_flat, s_mats, s_rays = cs.neural_rays(rbf, pbf)
    rbig, pbig = cs.neural_renderer(cs.NEURAL_RES, torch.float32,
                                    scene=cs.neural_scene("bfloat16"))
    b_flat, b_mats, b_rays = cs.neural_rays(rbig, pbig)
    for name, progs in bound.items():
        row = result["variants"][name]
        checks = {
            "bf16 backward vs plain (TOL_NEURAL_BWD_BF16)": lambda: row.update(
                bf16_backward=cs.neural_bf16_backward(
                    progs["bf16"], s_flat, s_mats, s_rays, seed=38)),
            "bf16 serving vs plain (TOL_BF16)": lambda: row.update(
                bf16_serving_max_abs=cs.compare(
                    f"{name}: bf16 serving {small}x{small}", progs["bf16"],
                    s_flat, s_rays, 0.0, False, cs.NEURAL_STEPS, s_mats,
                    tol=cs.TOL_BF16, max_share=cs.MAX_SHARE_OUT_BF16)),
            "f32 backward vs plain (TOL_NEURAL_BWD)": lambda: row.update(
                f32_backward=cs.neural_backward_vs_plain(
                    f"{name}: f32 {cs.NEURAL_RES}x{cs.NEURAL_RES} w256",
                    progs["f32"], flat, mats, rays7, 0.0,
                    cs.TOL_NEURAL_BWD["f32"],
                    modes=("history", "recompute", "two-level"), seed=31)),
        }
        row["failed"] = []
        for label, fn in checks.items():
            try:
                fn()
            except cs.SmokeFailure as exc:
                print(f"variant {name}: {label} FAILED: {exc}", flush=True)
                row["failed"].append(label)
        torch.cuda.empty_cache()
    rng = torch.Generator(device="cpu").manual_seed(37)
    g8 = torch.randn((8,) + tuple(rays7.shape[1:]), generator=rng).to(
        rays7.device)

    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk

    def history_bwd(prog, f, m, r):
        _, ex = rk.march_forward(prog, f, r, cs.NEURAL_STEPS, 0.0, 5e-2,
                                 log_hist=True, mats=m)
        return lambda: bk.fused_backward(
            prog, f, r, g8, cs.NEURAL_STEPS, 0.0, 5e-2, mats=m,
            hist=ex["hist"], nlive=ex["nlive"])

    for rnd in range(2):
        for name, progs in bound.items():
            row = result["variants"][name]
            times = {
                "f32 history backward": history_bwd(progs["f32"], flat, mats,
                                                    rays7),
                "bf16 history backward": history_bwd(progs["bf16"], b_flat,
                                                     b_mats, b_rays),
                "bf16 serving forward": lambda p=progs["bf16"]:
                    rk.march_forward(p, b_flat, b_rays, cs.NEURAL_STEPS, 0.0,
                                     5e-2, mats=b_mats),
            }
            for label, fn in times.items():
                ms = cs.kernel_ms(fn, 3 if "forward" in label else 2)
                row.setdefault(label + " ms", []).append(ms)
                print(f"round {rnd} {name}: {label} {ms:.4f} ms", flush=True)
            torch.cuda.empty_cache()
    for name, row in result["variants"].items():
        print(f"variant {name}: failed {row['failed'] or 'none'}; ptxas "
              f"(registers, stack, spill stores, static shared) of the "
              f"tensor-core history backward {row['ptxas_bwd_tc']}; "
              + "; ".join(f"{k} {sum(v) / len(v):.4f} (turns "
                          + ", ".join(f"{x:.4f}" for x in v) + ")"
                          for k, v in row.items() if k.endswith(" ms")),
              flush=True)
    return result


def run_accuracy(parent: str | None, only=None) -> dict:
    """The f32 accumulation schemes on the w256 field (module doc); ``only``:
    the names of :data:`ACC_VARIANTS` to run (default all)."""
    import torch

    cs = load_smoke()
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import march_kernel as mk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.scene.graph import param_paths

    card = cs.card_line()
    print(card, flush=True)
    names = ["acc-" + n for n in (only or ACC_VARIANTS)]
    assert all(n in VARIANTS for n in names), names
    for name in names:
        write_variant(name)
    write_variant("checkout", rk.CSRC)
    names.insert(0, "checkout")
    if parent:
        src = (Path(parent) / "ray_marching_tpu_torch" / "ops" / "csrc")
        write_variant("parent", src)
        names.insert(0, "parent")
    failed = build_all(names, only_f32=True)
    names = [n for n in names if n not in failed]
    result = {"card": card, "failed_builds": failed, "variants": {}}
    steps = cs.NEURAL_STEPS

    def bind(name):
        rk.CSRC = variant_dir(name)
        rk._BOUND.clear()

    # The references, on no kernel: the plain march in f64 and in f32.
    fused, p0 = cs.neural_renderer(cs.NEURAL_RES, torch.float32)
    plain32, _ = cs.neural_renderer(cs.NEURAL_RES, torch.float32,
                                    march_impl="xla")
    r64, p64 = cs.neural_renderer(cs.NEURAL_RES, torch.float64,
                                  march_impl="xla")
    q, t = cs.NEURAL_Q, cs.NEURAL_T
    with torch.no_grad():
        target = plain32.render(cs._scaled_tree(p0, 1.02), q, t, mode=0,
                                degree=1)
    conv_w = cs.converged_pixels(plain32, p0, q, t, steps)[..., None].to(
        torch.float32)

    def gradient(r, p0_, weight, target_=None):
        p = cs.leaf_params(p0_)
        img = torch.nan_to_num(r.render(p, q, t, mode=0, degree=1))
        err = img if target_ is None else img - target_
        torch.mean((err * weight) ** 2).backward()
        return {n: v.grad for n, v in param_paths(p).items()}

    losses = {"converged pixels": (conv_w, None),
              "every pixel": (1.0, None),
              "training loss": (1.0, target)}
    ref = {}
    for label, (w_, tgt) in losses.items():
        g64 = gradient(r64, p64, w_ if isinstance(w_, float) else w_.double(),
                       None if tgt is None else tgt.double())
        ref[label] = (g64, cs._leaf_scales(g64))
    del r64, p64, plain32
    flat, mats, rays7 = cs.neural_rays(fused, p0)
    prog = fused.program
    want, wex = rk._reference_march(prog, flat, rays7, steps, 0.0, 5e-2,
                                    track_min=True, log_hist=True, mats=mats)
    conv = (rays7[6] > 0.5) & (want[3].abs() < cs.CONVERGED)
    steps_idx = torch.arange(steps + 1, device=rays7.device)[:, None, None]
    del want
    for name in names:
        bind(name)
        row = result["variants"][name] = {}
        for label, (w_, tgt) in losses.items():
            g = gradient(fused, p0, w_, tgt)
            g64, scales = ref[label]
            row[f"grad {label} from f64"] = max(
                cs._leaf_dist(g[n], g64[n]) / scales[n] for n in g64)
        row["training loss grad sha256"] = hashlib.sha256(b"".join(
            g[n].cpu().numpy().tobytes() for n in sorted(g))).hexdigest()
        _, ex = rk.march_forward(prog, flat, rays7, steps, 0.0, 5e-2,
                                 track_min=True, log_hist=True, mats=mats)
        both = ((steps_idx < torch.minimum(ex["nlive"], wex["nlive"])[None])
                | (steps_idx == steps))[:, None]
        diff = torch.where(both, (ex["hist"] - wex["hist"]).abs(),
                           0.0).amax((0, 1))
        diff = torch.where(torch.isnan(diff), float("inf"), diff)
        row["history from plain"] = float(diff[conv].max())
        del ex
        print(f"variant {name}: " + "; ".join(
            f"{k} {v:.4e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
        torch.cuda.empty_cache()

    rng = np.random.default_rng(37)
    g8 = torch.as_tensor(rng.standard_normal((8,) + tuple(rays7.shape[1:])),
                         dtype=rays7.dtype).to(rays7.device)

    def timings():
        _, ex = rk.march_forward(prog, flat, rays7, steps, 0.0, 5e-2,
                                 log_hist=True, mats=mats)
        leaves = cs.leaf_params(p0)
        opt = torch.optim.Adam(list(param_paths(leaves).values()), lr=1e-4)

        def train_step():
            opt.zero_grad(set_to_none=True)
            torch.mean((fused.render(leaves, q, t, mode=0, degree=1)
                        - target) ** 2).backward()
            opt.step()

        return {
            "serving forward": (lambda: rk.march_forward(
                prog, flat, rays7, steps, 0.0, 5e-2, mats=mats), 5, True),
            "march": (lambda: mk.march_planes(prog, flat, rays7, steps, 0.0,
                                              mats), 5, True),
            "history backward": (lambda: bk.fused_backward(
                prog, flat, rays7, g8, steps, 0.0, 5e-2, mats=mats,
                hist=ex["hist"], nlive=ex["nlive"]), 2, True),
            "two-level backward": (lambda: bk.fused_backward(
                prog, flat, rays7, g8, steps, 0.0, 5e-2, mats=mats,
                two_level=True), 2, True),
            "training step": (train_step, 3, False),
        }

    for rnd in range(2):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            bind(name)
            row = result["variants"][name]
            for label, (fn, reps, kernel) in timings().items():
                ms = (cs.kernel_ms if kernel else cs.cuda_ms)(fn, reps)
                row.setdefault(label + " ms", []).append(ms)
                print(f"round {rnd} {name}: {label} {ms:.4f} ms", flush=True)
            torch.cuda.empty_cache()
    for name in names:
        log = (variant_dir(name).parent / "build_f32.log").read_text()
        row = result["variants"][name]
        row["ptxas_bwd_tc"] = cs.ptxas_entry(log, "render_bwd_kernel",
                                             BWD_TC_ARGS)
        row["ptxas_fwd_tc"] = cs.ptxas_entry(log, "render_fwd_tc_kernel",
                                             "PKf")
        print(f"variant {name}: " + "; ".join(
            f"{k} {sum(v) / len(v):.4f} (turns "
            + ", ".join(f"{x:.4f}" for x in v) + ")" if isinstance(v, list)
            else f"{k} {v}" for k, v in result["variants"][name].items()),
            flush=True)
    out = ROOT / "chiprun_out" / "tc_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "accuracy.json").write_text(json.dumps(result, indent=1))
    return result


def run_digest() -> dict:
    import torch

    cs = load_smoke()
    from ray_marching_tpu_torch.ops import render_kernel as rk

    r64, p64 = cs.neural_renderer(cs.NEURAL_F64_RES, torch.float64)
    flat, mats, rays7 = cs.neural_rays(r64, p64)
    digest = cs.neural_f64_digest(r64.program, flat, mats, rays7)
    print(f"package {Path(rk.__file__).resolve().parents[2]}: f64 neural "
          f"digest {digest} (pinned {cs.NEURAL_F64_DIGEST}: "
          f"{digest == cs.NEURAL_F64_DIGEST})", flush=True)
    return {"package": str(Path(rk.__file__).resolve().parents[2]),
            "digest": digest, "card": cs.card_line()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("variants", "accuracy", "digest",
                                         "build"))
    parser.add_argument("name", nargs="?", help="build: the variant")
    parser.add_argument("--only-f32", action="store_true",
                        help="build: the f32 library alone")
    parser.add_argument("--parent", help="accuracy: a parent commit's "
                        "package unpacked under this directory")
    parser.add_argument("--only", help="accuracy: comma-separated names of "
                        "ACC_VARIANTS (default all)")
    parser.add_argument("--package-root", default=str(ROOT),
                        help="the checkout whose ray_marching_tpu_torch runs")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_tc_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.mode == "build":
        build_one(args.name, args.only_f32)
        return 0
    result = (run_variants() if args.mode == "variants"
              else run_accuracy(args.parent, args.only and
                                args.only.split(","))
              if args.mode == "accuracy"
              else run_digest())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
