"""The port stands alone: importing `repro_torch` and every submodule (and
`scripts/torch_kernel_bench.py`) leaves jax out of `sys.modules`, and no
file of the port (nor the chip smoke script, nor `scripts/torch_*.py`)
imports jax or the JAX package `repro`."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == 'jax' or m.startswith('jax.') or m == 'repro'
                or m.startswith('repro.'))
print(len(names), leaked)
"""


def test_import_leaves_jax_out():
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    count, leaked = res.stdout.split(" ", 1)
    assert int(count) >= 20
    assert leaked.strip() == "[]"


BAD = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                 r"|from\s+(jax|repro)(\.|\s)(?!.*_torch))", re.M)


IMPORT_STAGES = """
import importlib.util, sys
import repro_torch.kernels, repro_torch.kernels.stages, repro_torch.kernels.ref
spec = importlib.util.spec_from_file_location(
    'torch_kernel_bench', 'scripts/torch_kernel_bench.py')
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
             or m == 'repro' or m.startswith('repro.')))
"""


def test_stage_surface_and_kernel_bench_leave_jax_out():
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_STAGES], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_sources_never_import_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(files) > 20
    for f in files:
        hits = BAD.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"
