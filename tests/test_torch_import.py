"""The PyTorch port imports with no JAX present, and its sources name no
JAX module."""

import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "quadray_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import quadray_tpu_torch
names = ["quadray_tpu_torch"]
for m in pkgutil.walk_packages(quadray_tpu_torch.__path__,
                               "quadray_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = [m for m in sys.modules if m.startswith(("jax", "quadray_tpu."))
       and sys.modules[m] is not None]
assert not bad, bad
print(" ".join(names))
"""


def test_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # package, 5 subpackages and every module below them, the path tracer,
    # the conformance tier and the parallel layer among them
    names = res.stdout.split()
    assert len(names) >= 19, names
    for m in ("ops.pt", "ops.conformance", "ops.cuda_kernel", "ops.trace",
              "parallel.mesh", "parallel.render", "parallel.distributed",
              "dryrun"):
        assert f"quadray_tpu_torch.{m}" in names, names


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|quadray_tpu)(\.|\s|$)")
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    offenders += [f"{path}:{i}: {line.strip()}"
                                  for i, line in enumerate(fh, 1)
                                  if pat.match(line)]
    assert not offenders, offenders
