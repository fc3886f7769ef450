"""The port's scene front end against the JAX package's: the loaded scene
descriptions, and the compiled SceneArrays."""

import dataclasses

import numpy as np
import pytest
import torch

from quadray_tpu.models.scenes import demos as jdemos
from quadray_tpu.models.scenes.loader import load_scene as jload
from quadray_tpu.scene import schema as JS
from quadray_tpu.scene.compile import compile_scene as jcompile
from quadray_tpu_torch.models.scenes import demos as tdemos
from quadray_tpu_torch.models.scenes.loader import load_scene as tload
from quadray_tpu_torch.scene import schema as TS
from quadray_tpu_torch.scene.compile import (
    FIELDS, compile_scene as tcompile, scene_arrays_from_numpy,
    scene_arrays_to_numpy)

torch.set_num_threads(1)

ALL = [f"test{i:02d}" for i in range(1, 19)] + ["demo01", "demo02", "demo03"]
COMPILED = ["test01", "test03", "test11", "test13", "test15", "test17",
            "demo01", "demo03"]


def _same(a, b, path="scene"):
    """Structural equality across the two packages' schema classes."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b) and a.dtype == b.dtype, path
    elif callable(a):
        assert callable(b), path
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("name", ALL)
def test_load_scene_matches_jax(name):
    _same(jload(name), tload(name))


def _row_ulps(a: np.ndarray, b: np.ndarray) -> float:
    """|a - b| in units of the f32 spacing at the magnitude of the row
    (the last axis) of `a`; scalars and vectors use each element."""
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    assert np.array_equal(a[~fin], b[~fin])
    mag = np.abs(np.where(fin, a, 0)).astype(np.float32)
    if a.ndim >= 2:
        mag = np.broadcast_to(mag.max(-1, keepdims=True), a.shape)
    spacing = np.spacing(mag)
    diff = np.abs(np.where(fin, a, 0).astype(np.float64)
                  - np.where(fin, b, 0))
    return float((diff / spacing).max()) if a.size else 0.0


def _compile_both(name, t):
    if t:
        jd, td = jdemos.build(name), tdemos.build(name)
    else:
        jd, td = jload(name), tload(name)
    j = jcompile(JS.SceneDef(root=jd.root, opts=JS.OPTS_FULL & ~jd.opts),
                 time=t)
    p = tcompile(TS.SceneDef(root=td.root, opts=TS.OPTS_FULL & ~td.opts),
                 time=t, device="cpu")
    return j, p


@pytest.mark.parametrize("name,t", [(n, 0.0) for n in COMPILED]
                         + [("demo02", 1.5)])
def test_compile_scene_matches_jax(name, t):
    """Integer fields equal; float fields bitwise on most scenes. Where
    not, sin/cos differ by an ulp between the JAX CPU backend (the C
    library's sinf/cosf) and the port (correctly rounded through
    float64), and the inverse's cancellation can turn that ulp into a
    residue of order 1e-15 where JAX has an exact 0. So the bar is 2
    ulps at the magnitude of each matrix row (measured max: 1)."""
    j, p = _compile_both(name, t)
    got = scene_arrays_to_numpy(p)
    for k in FIELDS:
        a = np.asarray(getattr(j, k))
        b = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            assert _row_ulps(a, b) <= 2.0, k
        else:
            assert np.array_equal(a, b), k


def test_scene_arrays_numpy_round_trip():
    j, _ = _compile_both("test03", 0.0)
    d = {k: np.asarray(getattr(j, k)) for k in FIELDS}
    back = scene_arrays_to_numpy(scene_arrays_from_numpy(d, device="cpu"))
    for k in FIELDS:
        assert np.array_equal(d[k], back[k]) and d[k].dtype == back[k].dtype
