"""Every public name of the JAX package has its counterpart in the port.

From the sources alone (``ast``; neither package is imported): each public
top-level function and class of every ``ray_marching_tpu/`` module, the
parameters of those that exist in both, every CLI subcommand and its flags,
and every ``RM_TPU_*`` switch. Each must exist under the same name in the
same-named port module (the Pallas modules map to ``ops/*_kernel.py``), or
stand in one of the tables below with its counterpart or its reason. A new
JAX name with neither fails here.
"""

import ast
import functools
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "ray_marching_tpu"
PORT = ROOT / "ray_marching_tpu_torch"

#: JAX module -> the port module that holds its counterparts.
MODULES = {
    "ops/pallas_render.py": "ops/render_kernel.py",
    "ops/pallas_backward.py": "ops/backward_kernel.py",
    "ops/pallas_march.py": "ops/march_kernel.py",
}
#: JAX modules with no port module, and why.
NO_MODULE = {
    "runtime.py": "the persistent JAX compile cache: the port's counterpart "
                  "is the nvcc build cache (ops/render_kernel.py BUILD_DIR), "
                  "always on",
}
#: (JAX module, name) -> (the counterpart "port module:name", or None for
#: none, and the reason).
ELSEWHERE = {
    ("ops/pallas_march.py", "pallas_march"):
        ("ops/march_kernel.py:kernel_march", "the CUDA march's entry"),
    ("ops/pallas_march.py", "pallas_march_with_distance"):
        ("ops/march_kernel.py:kernel_march_with_distance",
         "the CUDA march's entry"),
    ("ops/pallas_march.py", "split_params_padded"):
        ("ops/params.py:split_params_padded",
         "the kernels' parameter packing has a module of its own"),
    ("ops/pallas_march.py", "mat_in_specs"):
        (None, "TPU-only: the matrix inputs' BlockSpecs"),
    ("ops/pallas_march.py", "matmul_width"):
        (None, "TPU-only: sizes the VMEM tiles"),
    ("ops/pallas_march.py", "neural_compiler_params"):
        (None, "TPU-only: Mosaic's scoped-VMEM compiler parameters"),
    ("ops/pallas_march.py", "wide_vmem_bytes"):
        (None, "TPU-only: the VMEM budget of wide scenes"),
    ("ops/pallas_render.py", "fused_march_normals_cov_ift"):
        ("ops/render_kernel.py:fused_march_normals_ift",
         "one entry, track_min=True"),
    ("io/checkpoint.py", "save_pytree_orbax"):
        ("io/checkpoint.py:save_pytree_dcp", "orbax -> DCP"),
    ("io/checkpoint.py", "load_pytree_orbax"):
        ("io/checkpoint.py:load_pytree_dcp", "orbax -> DCP"),
    ("scene/graph.py", "tree_map_with_path"):
        ("scene/graph.py:map_params", "with param_paths"),
    ("scene/graph.py", "node_types"):
        ("scene/graph.py:param_paths", "map_params and param_paths"),
    ("scene/neural.py", "neural_sdf_componentwise"):
        ("scene/neural.py:mlp_componentwise", "renamed"),
    ("scene/neural.py", "neural_sdf_matmul"):
        ("scene/neural.py:mlp_matmul", "renamed"),
}
#: What still waits, and for what. The CLI's subcommand of the same
#: function waits with it.
WAITING = {("cli.py", "cmd_bench"): "waits for the port's benchmark"}
WAITING_SUBCOMMANDS = {"bench": "cmd_bench"}
#: JAX parameter names with no same-named port parameter, and why.
PARAMETERS = {
    "interpret": "TPU-only: Pallas interpret mode (the port's plain "
                 "versions run for CPU tensors)",
    "platforms": "TPU-only: the jax.export platforms",
    "devices": "TPU-only: a JAX device list (the port's ranks are "
               "processes, parallel/sharding.py)",
    "sdf_c": "the port's kernels take an SdfProgram (program)",
    "rebuild": "the port's kernels take an SdfProgram (program.rebuild)",
    "flat_params": "params_flat",
    "g8": "g",
    "nact": "nlive",
    "real_part": "real",
    "imag_part": "imag",
    "jit_cache_size": "no jit in the port: nothing is compiled per "
                      "configuration",
}
#: JAX CLI flags with no port flag, and why.
FLAGS = {
    "--cpu": "TPU-only: the port takes --device",
    "--platforms": "TPU-only: the jax.export platforms",
    "--compile-cache": "TPU-only: the nvcc build cache is always on",
}
#: RM_TPU_* switches the port does not read, and their counterpart.
SWITCHES = {
    "RM_TPU_BWD_HIST": "ops/render_kernel.py:BWD_HIST",
    "RM_TPU_BWD_TWO_LEVEL": "ops/render_kernel.py:BWD_TWO_LEVEL",
    "RM_TPU_COMPILE_CACHE": None,
    "RM_TPU_NEURAL_TILE": None,
    "RM_TPU_NEURAL_BWD_TILE": None,
    "RM_TPU_NEURAL_DUAL": None,
}
#: Why each switch without a counterpart has none.
SWITCHES_TPU_ONLY = {
    "RM_TPU_COMPILE_CACHE": "the JAX compile cache (the nvcc build cache "
                            "is always on)",
    "RM_TPU_NEURAL_TILE": "a TPU tile size",
    "RM_TPU_NEURAL_BWD_TILE": "a TPU tile size",
    "RM_TPU_NEURAL_DUAL": "a TPU scheduler probe, bitwise the normal branch",
}


@functools.lru_cache(maxsize=None)
def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _public(path):
    """{name: parameter names (None for a class without __init__)} of the
    module's public top-level functions and classes."""
    out = {}
    for node in _tree(path).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            init = [m for m in node.body if isinstance(m, ast.FunctionDef)
                    and m.name == "__init__"]
            out[node.name] = _params(init[0]) - {"self"} if init else None
    return out


def _params(fn):
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}


def _defined(path):
    """Every top-level name ``path`` defines or imports."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def _exists(target):
    module, name = target.split(":")
    return (PORT / module).exists() and name in _defined(PORT / module)


def _jax_modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def test_every_public_name_has_a_counterpart():
    missing = []
    for rel in _jax_modules():
        if rel in NO_MODULE:
            continue
        port = PORT / MODULES.get(rel, rel)
        assert port.exists(), f"no port module for {rel}"
        have, params = _defined(port), _public(port)
        for name, jparams in _public(JAX / rel).items():
            key = (rel, name)
            if key in WAITING:
                continue
            if key in ELSEWHERE:
                target, _ = ELSEWHERE[key]
                assert target is None or _exists(target), (key, target)
                continue
            if name not in have:
                missing.append(f"{rel}:{name}")
                continue
            if jparams and params.get(name) is not None:
                gap = jparams - params[name] - set(PARAMETERS)
                missing += [f"{rel}:{name}({p})" for p in sorted(gap)]
    assert not missing, f"JAX names with no port counterpart: {missing}"


def test_the_tables_hold_only_real_names():
    """Every table entry names something the JAX package still has, and
    cmd_bench is the only entry still waiting."""
    for rel, name in list(ELSEWHERE) + list(WAITING):
        assert name in _public(JAX / rel), (rel, name)
    for rel in NO_MODULE:
        assert (JAX / rel).exists() and not (PORT / rel).exists()
    assert set(WAITING) == {("cli.py", "cmd_bench")}
    jax_params = set().union(*(
        p for rel in _jax_modules() for p in _public(JAX / rel).values()
        if p))
    assert set(PARAMETERS) <= jax_params
    assert set(SWITCHES_TPU_ONLY) == {k for k, v in SWITCHES.items()
                                      if v is None}


def _cli(path):
    """{subcommand: its long flags} of a CLI module whose ``main`` adds
    subparsers to ``p`` and whose ``_add_render_args(p)`` adds the shared
    flags."""
    tree = _tree(path)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def flags(call):
        return {a.value for a in call.args
                if isinstance(a, ast.Constant) and str(a.value)
                .startswith("--")}

    shared = set()
    for node in ast.walk(funcs["_add_render_args"]):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            shared |= flags(node)
    subs, current = {}, None
    calls = (node for stmt in funcs["main"].body for node in ast.walk(stmt)
             if isinstance(node, ast.Call))
    for node in calls:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "add_parser":
            current = node.args[0].value
            subs[current] = set()
        elif isinstance(fn, ast.Attribute) and fn.attr == "add_argument":
            if current is not None:
                subs[current] |= flags(node)
        elif isinstance(fn, ast.Name) and fn.id == "_add_render_args":
            subs[current] |= shared
    return subs


def test_every_cli_subcommand_and_flag_has_a_counterpart():
    want, have = _cli(JAX / "cli.py"), _cli(PORT / "cli.py")
    assert "render" in want and "--grid-dtype" in want["render"]
    for sub, flags in want.items():
        if sub in WAITING_SUBCOMMANDS:
            assert ("cli.py", WAITING_SUBCOMMANDS[sub]) in WAITING
            assert sub not in have
            continue
        assert sub in have, f"cli {sub}"
        gap = flags - have[sub] - set(FLAGS)
        assert not gap, f"cli {sub}: {sorted(gap)}"
    assert set(FLAGS) <= set().union(*want.values())


def _switch_reads(root):
    """RM_TPU_* names read as string constants in ``root``'s code."""
    names = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(_tree(path)):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and re.fullmatch(r"RM_TPU_[A-Z0-9_]+", node.value)):
                names.add(node.value)
    return names


def test_every_switch_has_a_counterpart():
    mentioned = set()
    for path in JAX.rglob("*.py"):
        mentioned |= set(re.findall(r"RM_TPU_[A-Z0-9_]+", path.read_text()))
    read = _switch_reads(PORT)
    gap = []
    for name in sorted(mentioned):
        if name in read:
            continue
        if name not in SWITCHES:
            gap.append(name)
        elif SWITCHES[name] is not None:
            assert _exists(SWITCHES[name]), (name, SWITCHES[name])
    assert not gap, f"RM_TPU_* switches with no counterpart: {gap}"
    assert "RM_TPU_BWD_HIST_MAX" in read
    assert set(SWITCHES) <= mentioned and not set(SWITCHES) & read
