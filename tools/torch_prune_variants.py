#!/usr/bin/env python3
"""Where the union short-circuit pays in the backward kernel, on the H100.

Run from the root of a checkout on a machine with one card:

    python3 tools/torch_prune_variants.py [--reps N] [--rounds N]

It builds test_scene2's library three ways: unpruned, pruned as this
checkout ships it (the recompute and the two-level checkpoints march on
``scene_sdf_fwd``, the segment replays on the plain SDF), and pruned with
the segment replays pruned too (a copy of ``ops/csrc`` with the replay's
``march_ray`` calls handed ``march_bounds``, under ``_archive/``). It holds
the three backward kernels' gradients sha256-equal, then times the
two-level and the recompute backward of each at the main path's shapes
(1920×1080, 32 steps, tau = 0, f32) with ``chip_smoke.kernel_ms``, the
libraries in turns (forward order, then reversed, ``--rounds`` times).
Prints one JSON line and writes it to ``chiprun_out/prune_variants.json``.

    python3 tools/torch_prune_variants.py --build-cost [--rounds N]

times instead what the prune phase adds to ``chip_smoke.py``'s first
parallel build: its build list and SASS probes (``run_programs``,
``SASS_SCENES``) without the phase's (``PRUNE_BUILDS``) and with them, in
turns (without, with, with, without, ``--rounds`` times), each into a fresh
build directory under ``_archive/``. It writes
``chiprun_out/prune_build_cost.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: The segment replay's two march_ray calls in render_bwd.cu, and the same
#: calls handed the bounds (the pruned replay).
REPLAY_PRUNED = (
    ("replay, !skip);", "replay, !skip, march_bounds<T>(a.P));"),
    ("zero, replay);", "zero, replay, true, march_bounds<T>(a.P));"),
)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def replays_pruned(src):
    """render_bwd.cu's source with the segment replays handed the bounds."""
    for old, new in REPLAY_PRUNED:
        if src.count(old) != 1:
            raise SystemExit(f"{old!r} is not in render_bwd.cu once")
        src = src.replace(old, new)
    return src


def variant_csrc(name, transform):
    """A copy of ``ops/csrc`` under ``_archive/`` whose render_bwd.cu is
    ``transform`` of this checkout's."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    d = ROOT / "_archive" / f"csrc_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(rk.CSRC, d)
    bwd = d / "render_bwd.cu"
    bwd.write_text(transform(bwd.read_text()))
    return d


def build_cost(cs, rounds):
    """Seconds of the first parallel build of ``cs`` (chip_smoke) without
    and with the prune phase's libraries and probe, in turns."""
    from ray_marching_tpu_torch.ops import render_kernel as rk

    programs = cs.run_programs()
    sets = {
        "without": ({k: v for k, v in programs.items()
                     if k not in cs.PRUNE_BUILDS},
                    [s for s in cs.SASS_SCENES if s not in cs.PRUNE_BUILDS]),
        "with": (programs, list(cs.SASS_SCENES)),
    }
    build_dir = rk.BUILD_DIR
    scratch = ROOT / "_archive"
    scratch.mkdir(exist_ok=True)
    times = {}
    try:
        for _ in range(rounds):
            for name in ("without", "with", "with", "without"):
                progs, probe_set = sets[name]
                rk.BUILD_DIR = Path(tempfile.mkdtemp(dir=scratch))
                t0 = time.perf_counter()
                probes = cs.start_sass_probes({s: progs[s]
                                               for s in probe_set})
                rk.build_kernels(progs.values())
                for _, proc in probes.values():
                    log, _ = proc.communicate()
                    if proc.returncode != 0:
                        raise SystemExit(f"SASS probe build failed:\n{log}")
                times.setdefault(name, []).append(time.perf_counter() - t0)
                print(f"build {name} the prune phase's: {times[name][-1]:.1f} "
                      f"s for {len(progs)} libraries, {len(probes)} probes",
                      flush=True)
                shutil.rmtree(rk.BUILD_DIR)
    finally:
        rk.BUILD_DIR = build_dir
    return {"libraries": {k: len(v[0]) for k, v in sets.items()},
            "probes": {k: len(v[1]) for k, v in sets.items()},
            "turns_s": times,
            "mean_s": {k: sum(v) / len(v) for k, v in times.items()}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=10,
                        help="launches per timing")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of turns over the libraries")
    parser.add_argument("--build-cost", action="store_true",
                        help="time the prune phase's share of chip_smoke's "
                             "build instead")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from ray_marching_tpu_torch.ops import backward_kernel as bk
    from ray_marching_tpu_torch.ops import render_kernel as rk
    from ray_marching_tpu_torch.render.fast import FastRenderer
    from ray_marching_tpu_torch.scene import registry
    from ray_marching_tpu_torch.scene.codegen import SdfProgram

    cs = _chip_smoke()
    card = cs.card_line()
    if args.build_cost:
        result = {"card": card, **build_cost(cs, args.rounds)}
        line = json.dumps(result)
        print(line)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "prune_build_cost.json").write_text(line + "\n")
        return 0
    scene = registry.make_scene("test_scene2")
    progs = {"unpruned": SdfProgram(scene),
             "checkout": SdfProgram(scene, prune=True)}
    rk.build_kernels(progs.values())
    csrc = rk.CSRC
    rk.CSRC = variant_csrc("replays_pruned", replays_pruned)
    try:
        progs["replays pruned"] = SdfProgram(scene, prune=True)
        rk._load(progs["replays pruned"])
    finally:
        rk.CSRC = csrc
    main_r = FastRenderer(scene, cs.config(1920, 1080), dtype=torch.float32)
    flat, rays7 = cs.main_rays(main_r, cs.BENCH_Q, cs.BENCH_T)
    g8 = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (8,) + tuple(rays7.shape[1:])), dtype=rays7.dtype).to(rays7.device)
    modes = {"two-level": {"two_level": True}, "recompute": {}}
    digests = {}
    for name, p in progs.items():
        for mode, kw in modes.items():
            gflat, _, grays = bk.fused_backward(p, flat, rays7, g8, cs.STEPS,
                                                0.0, 5e-2, **kw)
            digests[(name, mode)] = (cs.bits_digest(gflat)
                                     + cs.bits_digest(grays))
    if len(set(digests.values())) != 1:
        raise SystemExit(f"the libraries' gradients differ: {digests}")
    order = list(progs) + list(progs)[::-1]
    times = {}
    for mode, kw in modes.items():
        for _ in range(args.rounds):
            for name in order:
                times.setdefault(f"{mode} {name}", []).append(cs.kernel_ms(
                    lambda: bk.fused_backward(progs[name], flat, rays7, g8,
                                              cs.STEPS, 0.0, 5e-2, **kw),
                    args.reps))
    result = {"card": card, "gradients_sha256_equal": True,
              "mean_ms": {k: sum(v) / len(v) for k, v in times.items()},
              "turns_ms": times}
    line = json.dumps(result)
    print(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "prune_variants.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
