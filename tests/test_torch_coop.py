"""The cooperative tail of the culled Whitted kernel (``csrc/whitted.cu``
``nearest_coop``/``occluded_coop``: once few rays of a warp are left, the
warp walks one ray at a time, its kept surfaces dealt out over the 32
lanes) and the 16-byte conformance kernels (``csrc/conformance.cu``).

On the CPU: the rule the cooperative nearest pass rests on (``ops/trace.py``
``coop_fold``: the kept surfaces dealt out by rank, folded per lane, then
reduced by the xor butterfly on (t, original id)) against the serial fold,
on random sets and on the real candidates of the plain ``intersect``; the
launch's ``COOP_MAX_LIVE``; the conformance wrapper's lengths and the
split of its kernel's 16-byte path, against jnp. On the card: the kernel
with the tail off, at its default and from the first segment, bitwise;
the conformance kernels at ragged lengths and unaligned views.

JAX is imported inside the tests that use it, so the card's tests run on
a GPU machine without it:
    python -m pytest tests/test_torch_coop.py --noconftest -q -m cuda
"""

import contextlib
import math
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import conformance as cf
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.rays import camera_rays
from quadray_tpu_torch.ops.trace import (
    BIG, NO_SRF, WARP, TraceConfig, _bounce, _fresh_state, bundle_reach,
    coop_fold, intersect, trace_rays)
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(1)

W, H = 64, 40
BITS = lambda t: t.contiguous().view(torch.int32)
# the conformance wrapper's lengths: under one 16-byte group, one group
# and a tail, and one 800x480 frame's elements and one more
LENGTHS = (1, 3, 5, 384_001)


def _scene(name, device="cpu"):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=device)


def _rays(sc, w=W, h=H):
    org, dirs = camera_rays(sc.cam_pos, sc.cam_hor, sc.cam_ver, sc.cam_nrm,
                            sc.cam_pov, w, h, 1)
    return org, dirs, sc.cam_pov.expand(dirs.shape[0])


def _serial_fold(t, ids, kept):
    """The kernel's walk of one ray: surface() over the kept rows in row
    order, a root counting if t < BIG and winning on a smaller t or an
    equal t and a smaller original id."""
    bt, bi = BIG, NO_SRF
    for tv, iv, k in zip(t, ids, kept):
        if k and tv < BIG and (tv < bt or (tv == bt and iv < bi)):
            bt, bi = tv, iv
    return np.float32(bt), bi


# ---- the cooperative nearest fold -------------------------------------------

@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(data=st.data())
def test_coop_fold_equals_serial_fold(data):
    """Random candidates: t from a small pool (ties between surfaces),
    NaN, BIG, inf and arbitrary floats; unique original ids in any order
    against the rows; any kept mask, so some lanes get no share or every
    lane none; 1 to 3 rounds of 32."""
    rays = data.draw(st.integers(1, 3))
    S_ = data.draw(st.integers(0, 80))
    pool = [0.25, 1.0, 1.0, 2.5, BIG, math.nan, math.inf, 3e29]
    tv = st.one_of(st.sampled_from(pool),
                   st.floats(0.0, 1e3, width=32, allow_nan=False))
    t = np.array([[data.draw(tv) for _ in range(S_)] for _ in range(rays)],
                 np.float32).reshape(rays, S_)
    ids = np.array(data.draw(st.permutations(range(4 * S_)))[:S_], np.int64)
    kept = np.array([[data.draw(st.booleans()) for _ in range(S_)]
                     for _ in range(rays)], bool).reshape(rays, S_)
    lanes = data.draw(st.sampled_from([WARP, 8, 1]))
    got_t, got_i = coop_fold(torch.from_numpy(t), torch.from_numpy(ids),
                             torch.from_numpy(kept), lanes)
    for r in range(rays):
        want_t, want_i = _serial_fold(t[r].tolist(), ids.tolist(),
                                      kept[r].tolist())
        assert int(got_i[r]) == want_i
        assert np.float32(got_t[r]).view(np.int32) == want_t.view(np.int32)


@pytest.mark.parametrize("name", ["test13", "test16", "demo02"])
def test_coop_fold_on_scene_candidates(name):
    """The real hit candidates of the plain intersect at 64x40, primary
    rays and the rays of their first bounce, the surfaces in the kernel's
    row order: dealt over the warp's lanes and reduced, the winner is the
    serial fold's and the plain tracer's nearest hit, bitwise, whether the
    walk keeps every surface or the ray's own reach mask (the cooperative
    tail's one-ray bundle: conservative, so the same winner). test16
    holds clip programs, demo02 three lights."""
    sc = _scene(name)
    struct = ck.scene_struct(sc)
    n = struct.n_real
    perm = torch.tensor(struct.perm[:n], dtype=torch.long)
    spheres = ck.pack_scene(sc, struct).bsph_t[:, 0, :n]
    org, dirs, tmin = _rays(sc)
    N = dirs.shape[0]
    cfg = TraceConfig()
    st0 = _fresh_state(org[None, :].expand(N, 3), dirs, tmin, cfg.stack)
    st1, _ = _bounce(sc, cfg, st0)
    checked = 0
    for stt in (st0, st1):
        on = stt["active"]
        h = intersect(sc, stt["org"][on], stt["dir"][on], stt["tmin"][on],
                      torch.full((int(on.sum()),), BIG),
                      stt["osrf"][on], stt["oside"][on], stt["thru"][on],
                      origin_loc=stt["oloc"][on], per_surface=True)
        t_rows = h["t_srf"][:, perm]
        want_t = torch.where(h["hit"], h["t"], BIG)
        want_i = torch.where(h["hit"], h["srf"].long(), NO_SRF)
        reach = bundle_reach(stt["org"][on][:, None], stt["dir"][on][:, None],
                             torch.ones((int(on.sum()), 1), dtype=torch.bool),
                             spheres, False)
        for kept in (torch.ones_like(t_rows, dtype=torch.bool), reach):
            for lanes in (WARP, 1):
                got_t, got_i = coop_fold(t_rows, perm, kept, lanes)
                assert torch.equal(got_i, want_i)
                assert torch.equal(BITS(got_t), BITS(want_t))
        checked += int(h["hit"].sum())
    assert checked > N // 2


# ---- the launch's switch ------------------------------------------------------

def test_coop_max_live_is_in_range():
    assert 0 <= ck.COOP_MAX_LIVE <= WARP
    assert ck.ARGTYPES["whitted_launch"][-5] is ck.ctypes.c_int


@pytest.mark.parametrize("bad", [-1, WARP + 1])
def test_coop_max_live_out_of_range_raises(bad, monkeypatch):
    sc = _scene("test01")
    monkeypatch.setattr(ck, "COOP_MAX_LIVE", bad)
    with pytest.raises(ValueError):
        ck.trace_rays_cuda(sc, *_rays(sc, 8, 4))


def test_coop_max_is_passed_to_the_launch(monkeypatch):
    """The ctypes call of trace_rays_cuda, with the library, the device
    and the stream stood in for (meta tensors take the launch path): the
    cooperative tail's switch goes after the stream, as whitted_launch
    reads it, and the call has the bound argument count."""
    sc = _scene("test13")
    calls = []
    fake = types.SimpleNamespace(
        whitted_launch=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(ck, "_lib", lambda: fake)
    monkeypatch.setattr(ck, "_launch_inputs", lambda fn, sc, org, dirs, t,
                        struct, ps: (torch.zeros((7, dirs.shape[0])),
                                     (0,) * 12 + (struct.ns,)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(ck, "COOP_MAX_LIVE", 7)
    meta = lambda *s: torch.empty(s, device="meta")
    before = ck.launches
    ck.trace_rays_cuda(sc, meta(3), meta(64, 3), meta(64))
    (args,) = calls
    assert len(args) == len(ck.ARGTYPES["whitted_launch"])
    # then the per-ray masks' floor and their most rays, Schlick's flag
    # and the stack scratch
    assert args[-6:-4] == (1234, 7)
    assert args[-7] == ck.cull_gates(ck.scene_struct(sc),
                                     TraceConfig()).flags != 0
    assert ck.launches == before + 1


# ---- the conformance kernels' 16-byte path ----------------------------------

@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_vector_split(n, offset):
    """Whole 16-byte groups where every tensor is aligned, the ragged
    tail one by one; all one by one from a view one element in."""
    base = torch.zeros(n + 8)
    assert base.data_ptr() % 16 == 0
    x, out = base[offset:offset + n], torch.empty(n)
    want = (n - n % 4, n % 4) if offset == 0 else (0, n)
    assert cf.vector_split(n, out, x) == want
    assert sum(want) == n


@pytest.mark.parametrize("n", LENGTHS)
def test_conformance_lengths_match_jnp(n):
    """The wrapper takes any length for the elementwise cases (on the
    CPU, their plain versions): the cases whose JAX function is one or two
    correctly rounded jnp ops, bitwise, at each length; the gather keeps
    its (R, 128) rows."""
    import jax.numpy as jnp
    want = {"add": lambda x, y: x + y, "mul": lambda x, y: x * y,
            "div": lambda x, y: x / y, "sqrt": jnp.sqrt,
            "fma": lambda x, y: x * y + y,
            "min_max": lambda x, y: jnp.maximum(x, y) - jnp.minimum(x, y),
            "abs_neg": lambda x: abs(-x)}
    rows = -(-n // 128)
    before = cf.launches
    for name, fn in want.items():
        args = [a.reshape(-1)[:n] for a in cf.case_inputs(name, rows)]
        got = cf.conformance(name, *(torch.from_numpy(a) for a in args))
        ref = np.asarray(fn(*(jnp.asarray(a) for a in args)), np.float32)
        assert got.shape == (n,)
        assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    assert cf.launches == before
    with pytest.raises(ValueError):
        cf.conformance("gather", torch.zeros(n), torch.zeros(n, dtype=torch.int32))


# ---- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test13", "test16", "test17", "demo02"])
def test_coop_tail_is_bitwise_on_card(name, monkeypatch):
    """The cull floor lowered to 1 so every scene takes the culled
    instantiations (test17 pushes branches): the tail off, at its default
    and from every warp's first segment, bitwise equal to each other and
    to the plain tracer, one launch each."""
    dev = _card()
    monkeypatch.setattr(ck, "CULL_MIN_SURFACES", 1)
    sc = _scene(name, dev)
    rays = _rays(sc, 200, 120)
    assert ck.cull_gates(ck.scene_struct(sc), TraceConfig()).cull
    runs = []
    for coop in (0, ck.COOP_MAX_LIVE, WARP):
        monkeypatch.setattr(ck, "COOP_MAX_LIVE", coop)
        before = ck.launches
        runs.append(ck.trace_rays_cuda(sc, *rays))
        assert ck.launches == before + 1
    want = trace_rays(sc, *rays, TraceConfig())
    torch.cuda.synchronize()
    for got in runs:
        assert torch.equal(BITS(got), BITS(want))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_conformance_lengths_on_card(n, offset):
    """Every elementwise case at each length, from aligned tensors and
    from views one element in (the path one element a thread), against
    its plain version on the card: bitwise, FEQ at
    tests/test_conformance.py's scales where a math library function is
    in the chain; the gather on (R, 128) rows of an unaligned view."""
    dev = _card()
    feq = {"exp": 4.0, "log": 4.0, "spec_pow": 64.0, "roots": 8.0,
           "fresnel": 8.0, "root_sdiv": 8.0}
    rows = -(-(n + offset) // 128)
    for name in cf.CASES:
        flat = [torch.from_numpy(a).reshape(-1).to(dev)
                for a in cf.case_inputs(name, rows + 1)]
        if name == "gather":
            args = [a[offset:offset + rows * 128].view(rows, 128)
                    for a in flat]
        else:
            args = [a[offset:offset + n] for a in flat]
        before = cf.launches
        got = cf.conformance(name, *args)
        want = cf.plain(name, *args)
        torch.cuda.synchronize()
        assert cf.launches == before + 1
        if name in feq:
            a = got.double().cpu().numpy()
            b = want.double().cpu().numpy()
            tol = feq[name] * np.finfo(np.float32).eps * np.maximum(
                np.maximum(np.abs(a), np.abs(b)), 1e-20)
            assert not (np.abs(a - b) > tol).any(), name
        else:
            assert torch.equal(BITS(got), BITS(want)), name
