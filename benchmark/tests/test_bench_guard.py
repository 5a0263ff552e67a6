"""No run of the benchmark holds JAX or the JAX package, and the plain
reference holds nothing of the program."""

import ast
import os

import pytest

from harness import guard, spec


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("optax", True), ("orbax.checkpoint", True),
    ("rl_mpc_lanemerging_tpu", True), ("rl_mpc_lanemerging_tpu.ops", True),
    ("rl_mpc_lanemerging_torch", False),
    ("rl_mpc_lanemerging_torch.ops.st_kernel", False),
    ("jaxtyping", False), ("flaxen", False), ("torch", False)])
def test_top_level_names_compared_whole(name, bad):
    assert (guard.forbidden_modules([name]) == [name]) is bad


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    top = os.path.join(spec.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        for name in _imports(path):
            assert not guard.forbidden_modules([name]), (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("rl_mpc_lanemerging_torch", "harness"), \
                (path, name)
            assert not guard.forbidden_modules([name]), (path, name)


def test_a_run_module_set_is_clean():
    import sys
    import harness.main  # noqa: F401  (the harness and the program)
    import rl_mpc_lanemerging_torch.tasks  # noqa: F401
    loaded = [n for n in sys.modules
              if n.split(".")[0] in ("harness", "reference",
                                     "rl_mpc_lanemerging_torch")]
    assert loaded and not guard.forbidden_modules(loaded)
