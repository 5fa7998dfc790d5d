"""The port imports nothing of JAX or of the JAX package (the card's machine has neither).

In a fresh interpreter, a ``sys.meta_path`` finder refuses ``jax`` (and
``jaxlib``), ``kai0_tpu`` with every submodule, ``safetensors`` and ``optax``, which
the card's machine lacks too, and ``pandas`` and ``tqdm``, which it is not
promised (the JAX package's data tools use them); then every module of
``kai0_tpu_torch`` (found by ``pkgutil.walk_packages``), ``chip_smoke.py`` and
the port's scripts (``scripts/*_torch.py``, ``scripts/time_*.py``) are
imported, the scripts under another name than ``__main__``. Imports inside
functions run only when a phase reaches them, so the same files are also
read for any ``import`` statement of those packages, at any depth.
"""

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib", "kai0_tpu", "safetensors", "optax", "pandas", "tqdm")
SCRIPTS = sorted([*REPO.glob("scripts/*_torch.py"), *REPO.glob("scripts/time_*.py")])

_CHILD = r"""
import importlib, importlib.abc, importlib.util, pathlib, pkgutil, sys

REFUSED = {refused!r}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {{name}}")
        return None


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
import kai0_tpu_torch

names = ["kai0_tpu_torch"] + [m.name for m in pkgutil.walk_packages(kai0_tpu_torch.__path__, "kai0_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
for i, path in enumerate({scripts!r}):
    spec = importlib.util.spec_from_file_location(f"port_script_{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print(len(names), "modules")
"""


def test_the_port_imports_neither_jax_nor_the_jax_package():
    code = _CHILD.format(refused=REFUSED, repo=str(REPO), scripts=[str(p) for p in SCRIPTS])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert int(out.stdout.split()[-2]) > 50  # every module of the package was reached
    assert {p.name for p in SCRIPTS} >= {"train_torch.py", "serve_policy_torch.py", "annotate_advantage_torch.py",
                                         "discretize_advantage_torch.py", "model_arithmetic_torch.py",
                                         "dump_data_torch.py", "compute_norm_stats_torch.py",
                                         "compute_norm_stats_fast_torch.py", "space_mirroring_torch.py",
                                         "time_scaling_torch.py", "convert_h5_lerobot_torch.py",
                                         "merge_lerobot_torch.py", "split_lerobot_torch.py",
                                         "inference_client_torch.py", "dagger_collect_torch.py"}


def test_no_import_statement_of_jax_or_the_jax_package_at_any_depth():
    files = [*sorted((REPO / "kai0_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py", *SCRIPTS]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno}: {n}" for n in names if n.split(".")[0] in REFUSED]
    assert not found, found
