"""Ranks of a gloo process group as child processes, for the port's
parallel tests (tests/test_torch_parallel_*.py, test_torch_multihost_export.py).

Each child is ``python -c <PROLOGUE + body>`` with argv ``rank world store
out``: it joins the group through ``file://<store>`` (no port, so test
workers running side by side never meet), runs one torch thread, imports
neither jax nor ``ray_marching_tpu``, and saves the dict ``R`` to
``<out>/rank<rank>.npz``. The parent starts the ranks, computes the JAX side
meanwhile, then waits for them.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent

PROLOGUE = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, out = sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    R = {}
""")

EPILOGUE = textwrap.dedent("""
    assert "jax" not in sys.modules and "ray_marching_tpu" not in sys.modules
    np.savez(f"{out}/rank{rank}.npz", **R)
    dist.destroy_process_group()
""")


class Ranks:
    """``world`` child ranks running ``body`` (the prologue's names in
    scope); :meth:`results` waits and returns each rank's saved dict."""

    def __init__(self, tmp_path, body, world, env=None, epilogue=EPILOGUE):
        self.out = Path(tmp_path)
        self.out.mkdir(parents=True, exist_ok=True)
        code = PROLOGUE + textwrap.dedent(body) + epilogue
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = (str(REPO) + os.pathsep
                                   + child_env.get("PYTHONPATH", ""))
        child_env.update(env or {})
        store = self.out / "store"
        self.outs = None
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-c", code, str(rank), str(world),
                 str(store), str(self.out)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=child_env, cwd=REPO)
            for rank in range(world)]

    def wait(self, timeout=300):
        """``[(returncode, stdout, stderr)]`` by rank; kills what is left."""
        if self.outs is not None:
            return self.outs
        outs = []
        try:
            for p in self.procs:
                out, err = p.communicate(timeout=timeout)
                outs.append((p.returncode, out, err))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        self.outs = outs
        return outs

    def results(self, timeout=300):
        outs = self.wait(timeout)
        for rank, (rc, out, err) in enumerate(outs):
            assert rc == 0, f"rank {rank} failed rc={rc}\n{out}\n{err}"
        return [dict(np.load(self.out / f"rank{r}.npz"))
                for r in range(len(outs))]


def stable_mask(fast, q, t):
    """(N, H, W, 1) stable pixels (rays that converged, |d| < 1e-2, within
    |p| < 10) of a port FastRenderer's one-process march."""
    with torch.no_grad():
        origin, dirs = fast._pose_planes(*fast._pose(q, t))
        hit, _ = fast._march_planes(fast.init_params, origin, dirs,
                                    fast.config.marching_steps)
    stable = (hit[3].abs() < 1e-2) & (
        torch.sqrt(hit[0] ** 2 + hit[1] ** 2 + hit[2] ** 2) < 10)
    return fast._assemble([stable]).numpy()
