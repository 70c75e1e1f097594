"""Variants of the port's tensor-core CUDA sources, built and measured side
by side on one card, and the f64 neural digest of any checkout of the port.

    python tools/torch_tc_variants.py variants
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

``digest`` prints ``chip_smoke.neural_f64_digest`` (the f64 training
forward's history and the backward's cotangents at 128², per thread) as the
package under ``--package-root`` (default: this checkout) computes it, so
that the pinned ``chip_smoke.NEURAL_F64_DIGEST`` can be checked against
another commit unpacked there.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
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
#: The f32 tensor-core history backward's mangled template arguments.
BWD_TC_ARGS = "IfLb0ELb0ELb0ELb1EE"


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


def write_variant(name: str) -> Path:
    """The patched copy of the kernel sources for ``name``."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    out = variant_dir(name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(rk.CSRC, out)
    for fname, reps in VARIANTS[name].items():
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


def build_one(name: str) -> None:
    """Build the variant's libraries (run in a process of its own) and keep
    the f32 library's ptxas report beside its sources."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    cs = load_smoke()
    rk.CSRC = variant_dir(name)
    progs = programs(cs)
    rk.build_kernels(list(progs.values()))
    (rk.CSRC.parent / "build_f32.log").write_text(
        rk.BUILD_LOG.get(rk.kernel_key(progs["f32"]), ""))


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
    for name in VARIANTS:
        write_variant(name)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, __file__, "build", name])
             for name in VARIANTS}
    failed_builds = []
    try:
        for name, proc in procs.items():
            if proc.wait() != 0:
                print(f"variant {name}: build FAILED", flush=True)
                failed_builds.append(name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"built {len(VARIANTS)} variants in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    result = {"card": card, "failed_builds": failed_builds, "variants": {}}
    bound = {}
    for name in VARIANTS:
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
    parser.add_argument("mode", choices=("variants", "digest", "build"))
    parser.add_argument("name", nargs="?", help="build: the variant")
    parser.add_argument("--package-root", default=str(ROOT),
                        help="the checkout whose ray_marching_tpu_torch runs")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_tc_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.mode == "build":
        build_one(args.name)
        return 0
    result = run_variants() if args.mode == "variants" else run_digest()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
