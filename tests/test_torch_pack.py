"""The port's kernel structure and packed tables against the JAX
package's, from the same numpy SceneArrays."""

import numpy as np
import pytest
import torch

import quadray_tpu.ops.pallas_kernel as pk
from quadray_tpu.models.scenes.loader import load_scene
from quadray_tpu.scene import schema as S
from quadray_tpu.scene.compile import compile_scene
import quadray_tpu_torch.ops.cuda_kernel as ck
from quadray_tpu_torch.scene.compile import FIELDS, scene_arrays_from_numpy

torch.set_num_threads(1)

SCENES = ["test01", "test03", "test11", "test13", "test15", "test17",
          "demo01", "demo03"]
TABLES = ("sp_f", "sp_i", "cl_f", "mat_f", "lg_f", "misc", "tex_pk",
          "tex_lut")


def _both(name):
    sd = load_scene(name)
    j = compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts))
    t = scene_arrays_from_numpy({k: np.asarray(getattr(j, k))
                                 for k in FIELDS}, device="cpu")
    return j, t


@pytest.mark.parametrize("name", SCENES)
def test_struct_and_tables_match_jax(name):
    j, t = _both(name)
    js, ts = pk.scene_struct(j), ck.scene_struct(t)
    for f in js._fields:
        assert getattr(js, f) == getattr(ts, f), f
    jp, tp = pk.pack_scene(j, js), ck.pack_scene(t, ts)
    for f in TABLES:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_mat_i_carries_static_material_structure():
    _, t = _both("test03")
    st = ck.scene_struct(t)
    mat_i = ck.pack_scene(t, st).mat_i.numpy()
    assert tuple(mat_i[:, 0]) == st.props
    textured = {m: (b, xm, ym, xs) for (m, b, xm, ym, xs) in st.tex}
    assert textured
    for m in range(st.nm):
        assert tuple(mat_i[m, 1:]) == textured.get(m, (-1, 0, 0, 0))


def test_scene_cache_keys_on_every_field():
    _, t = _both("test01")
    cache = ck._SceneCache(ck.scene_struct)
    a = cache(t)
    assert cache(t) is a
    import dataclasses
    t2 = dataclasses.replace(t, l_on=t.l_on.clone())
    assert cache(t2) is not a


def test_light_prefix_assert():
    import dataclasses
    _, t = _both("test11")
    l_on = t.l_on.clone()
    l_on[0] = 0.0
    with pytest.raises(AssertionError, match="contiguous prefix"):
        ck.scene_struct(dataclasses.replace(t, l_on=l_on))
