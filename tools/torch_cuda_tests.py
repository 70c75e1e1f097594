"""Run the port's ``cuda``-marked tests on a machine with a card and no jax.

    python tools/torch_cuda_tests.py [pytest arguments ...]

The test files of the port import the JAX package at the top, and
``tests/conftest.py`` configures jax; the ``cuda`` tests use neither. This
runner answers every import of ``jax``, ``optax`` and ``ray_marching_tpu``
(not ``ray_marching_tpu_torch``) with a stub module, skips the conftest and
runs pytest in this process on ``tests/test_torch_*.py -m cuda`` but
:data:`NEEDS_JAX` (or on the test paths given). A stub module has no
attributes: ``import jax`` and ``from jax import numpy`` resolve (to further
stubs), but reading any name from a stub raises :class:`StubbedError`, and
a name imported from one is itself a stub module, which cannot be called,
compared with a number or turned into one. A test that reached the JAX side
fails loudly; it cannot pass on a stand-in value.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: Top-level packages the card's machine does not have.
STUBBED = ("jax", "jaxlib", "optax", "ray_marching_tpu")
#: Test files whose cuda tests take their inputs from the JAX package (a
#: fixture compiles the JAX scene): chip_smoke.py covers those kernels.
NEEDS_JAX = ("test_torch_backward_kernel.py", "test_torch_render_kernel.py")


class StubbedError(AttributeError):
    """A name read from a stubbed module. An AttributeError, so that the
    import system's ``from x import y`` falls back to importing ``x.y``
    (another stub); everywhere else it ends the test with an error."""


class _StubModule(types.ModuleType):
    def __getattr__(self, name):
        raise StubbedError(f"{self.__name__}.{name}: {self.__name__} is "
                           "stubbed (no jax on this machine)")


class _Stubs(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in STUBBED:
            return importlib.machinery.ModuleSpec(name, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        module = _StubModule(spec.name)
        module.__spec__, module.__path__ = spec, []
        return module

    def exec_module(self, module):
        pass


def main(argv=None) -> int:
    import pytest

    sys.path.insert(0, str(ROOT))
    sys.meta_path.insert(0, _Stubs())
    args = list(sys.argv[1:] if argv is None else argv)
    if all(a.startswith("-") for a in args):
        args += sorted(str(p) for p in (ROOT / "tests").glob("test_torch_*.py")
                       if p.name not in NEEDS_JAX)
    return pytest.main(["-q", "-n", "0", "--noconftest", "-p",
                        "no:cacheprovider", "-m", "cuda", "-rs", *args])


if __name__ == "__main__":
    sys.exit(main())
