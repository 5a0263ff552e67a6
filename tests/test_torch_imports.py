"""The PyTorch port stands alone: no module of ``rl_mpc_lanemerging_torch``,
nor ``chip_smoke.py``, nor the port's scripts (``scripts/*_torch.py``)
imports JAX, Flax, optax, orbax or the JAX package.
Each file is parsed, not imported, so that an import inside a function
counts too."""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "rl_mpc_lanemerging_tpu")


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")] + sorted(
        glob.glob(os.path.join(REPO, "scripts", "*_torch.py")))
    for root, dirs, files in os.walk(os.path.join(REPO,
                                                  "rl_mpc_lanemerging_torch")):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        paths += [os.path.join(root, f) for f in sorted(files)
                  if f.endswith(".py")]
    return paths


def imported_modules(path):
    """Every module an ``import`` or ``from ... import`` in ``path`` names
    (relative imports resolved to the package they start from)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_every_port_script_is_scanned():
    names = {os.path.basename(p) for p in _sources()}
    assert {"paper_table_torch.py", "train_curve_torch.py",
            "eval_ddpg_torch.py"} <= names


def test_the_guard_sees_imports_inside_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n\ndef f():\n    from jax import numpy\n"
                   "    import orbax.checkpoint as ocp\n")
    assert list(imported_modules(str(src))) == ["os", "jax",
                                                "orbax.checkpoint"]
