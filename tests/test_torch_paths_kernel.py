"""The host side of the path-record kernel (``csrc/whitted.cu``
``paths_kernel``, launched by ``whitted_paths_launch`` from
``ops/cuda_kernel.py`` ``_paths``): the shared-memory plan of a block's
scene tables (``paths_staging``, mirrored in ``ops/cuda_kernel.py``)
against the C function itself, built with g++, and against the pack's
tables, with the instantiation it picks for test01, test13, demo03 and
a scene too large to fit; the wrapper's launch arguments and its work
queue's scratch through a stood-in library on meta tensors; the C entry
points against ``ARGTYPES``. On the card: both walks and both
instantiations bitwise against the plain records at the edges of the
persistent grid and of a ragged warp, and two launches bitwise equal.

No JAX here: the card's tests run on a GPU machine without it:
    python -m pytest tests/test_torch_paths_kernel.py --noconftest -q -m cuda
"""

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import types

import pytest
import torch

from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.ops import cuda_kernel as ck
from quadray_tpu_torch.ops.trace import TraceConfig, trace_paths
from quadray_tpu_torch.scene import schema as S
from quadray_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "quadray_tpu_torch", "csrc", "whitted.cu")
# the training step's configuration (bench_train, chip_smoke.py phase D)
CFG, K = TraceConfig(max_segments=8, stack=4), 8
# the persistent grid's and a ragged warp's edges: one ray, a warp less
# one, a warp and one more, 128 warps and one more ray, an 800x480 frame
# and one more
EDGES = (1, 31, 33, 4097, 800 * 480 + 1)
BITS = lambda t: t.contiguous().view(torch.int32)


def _scene(name, device="cpu"):
    sd = load_scene(name)
    return compile_scene(S.SceneDef(root=sd.root, opts=S.OPTS_FULL & ~sd.opts),
                         device=device)


def _source():
    with open(SRC) as fh:
        return fh.read()


# ---- the shared-memory plan ---------------------------------------------------

def _c_block(src, start):
    """The text of the C++ definition that starts at `start`, to its
    closing brace."""
    at = src.index(start)
    depth, i = 0, src.index("{", at)
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            return src[at:i]


@pytest.fixture(scope="module")
def kernel_plan(tmp_path_factory):
    """csrc/whitted.cu's own paths_staging (with its constants and the
    Staging struct), built with g++ into a library: plan(ns, nc, nm, nl,
    out) fills out with off[7], bytes[7], total and returns whether the
    tables fit."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel's host function on the CPU"
    src = _source()
    consts = [re.search(r"constexpr int PF = [^;]*;", src).group(0),
              re.search(r"constexpr int PATHS_SMEM = [^;]*;", src).group(0),
              re.search(r"constexpr int P_TABLES = [^;]*;", src).group(0)]
    code = "\n".join(consts + [
        _c_block(src, "struct Staging {") + ";",
        _c_block(src, "static bool paths_staging("),
        'extern "C" int plan(int ns, int nc, int nm, int nl, int* out) {',
        "  Staging st{};",
        "  const bool ok = paths_staging(ns, nc, nm, nl, st);",
        "  for (int k = 0; k < P_TABLES; ++k) {",
        "    out[k] = st.off[k];",
        "    out[P_TABLES + k] = st.bytes[k];",
        "  }",
        "  out[2 * P_TABLES] = st.total;",
        "  return ok;",
        "}"])
    d = tmp_path_factory.mktemp("plan")
    (d / "plan.cpp").write_text(code)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(d / "plan.so"), str(d / "plan.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "plan.so"))
    lib.plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]

    def plan(ns, nc, nm, nl):
        out = (ctypes.c_int * 15)()
        ok = lib.plan(ns, nc, nm, nl, out)
        return ck.PathsStaging(tuple(out[0:7]), tuple(out[7:14]),
                               out[14]) if ok else None
    return plan


def _struct(ns, nc, nm, nl):
    return types.SimpleNamespace(n_real=ns, nc=nc, nm=nm, nl=nl)


def test_the_budget_is_the_kernels():
    src = _source()
    m = re.search(r"constexpr int PATHS_SMEM = (\d+) \* 1024;", src)
    assert int(m.group(1)) * 1024 == ck.PATHS_SMEM_BYTES
    assert re.search(r"constexpr int P_TABLES = (\d+);", src).group(1) \
        == str(len(ck.PATHS_TABLES))
    # two blocks an SM and their 1 KB reserves in the SM's 228 KB
    assert 2 * (ck.PATHS_SMEM_BYTES + 1024) <= 228 * 1024


def _edges():
    """(ns, nc, nm, nl) on either side of the budget: the most surfaces
    whose tables fit with cl_f, and without it."""
    out = []
    for nc, nm, nl in ((1, 6, 1), (2, 10, 1), (8, 11, 16), (3, 64, 0)):
        fixed = 16 + sum(-(-b // 16) * 16 for b in (
            4 * nm * ck.MF, 4 * nm * ck.MI, 4 * nl * ck.LF, 32))
        core = (ck.PATHS_SMEM_BYTES - fixed) // (4 * (ck.PF + 8))
        full = (ck.PATHS_SMEM_BYTES - fixed) // (4 * (ck.PF + 8 + nc * ck.CF))
        for ns in (full - 1, full, full + 1, core - 1, core, core + 1):
            out.append((ns, nc, nm, nl))
    return out


@pytest.mark.parametrize("ns, nc, nm, nl", [
    (0, 1, 1, 0), (1, 1, 1, 1), (4, 1, 4, 1), (104, 2, 10, 1),
    (152, 1, 6, 1), (43, 8, 11, 1), (488, 2, 12, 1), (1024, 1, 3, 16),
    (5000, 4, 200, 16)] + _edges())
def test_plan_mirrors_the_kernel(kernel_plan, ns, nc, nm, nl):
    """ops/cuda_kernel.py paths_staging is the kernel's own plan, byte
    for byte, on common scenes and on either side of the budget."""
    want = kernel_plan(ns, nc, nm, nl)
    got = ck.paths_staging(_struct(ns, nc, nm, nl))
    assert got == want
    if got is not None:
        assert got.total <= ck.PATHS_SMEM_BYTES
        assert all(o % 16 == 0 for o in got.off)
        assert got.off[0] == 16   # the mbarrier's 16 bytes first


def test_plan_leaves_cl_f_in_device_memory_where_only_it_does_not_fit():
    s = _struct(104, 2, 10, 1)
    core_only = s.n_real * 4 * (ck.PF + 8)
    big_nc = -(-(ck.PATHS_SMEM_BYTES - core_only) // (4 * ck.CF * 104)) + 1
    st = ck.paths_staging(_struct(104, big_nc, 10, 1))
    assert st is not None and st.bytes[2] == 0
    assert ck.paths_staging(s).bytes[2] == 4 * 104 * 2 * ck.CF


def _crowded(extra, device="cpu"):
    from chip_smoke import crowded_scene
    return crowded_scene(device, extra)


@pytest.mark.parametrize("name", ["test01", "test13", "demo03", "crowd384",
                                  "crowd640"])
def test_plan_against_the_pack(name):
    """The plan's bytes are the rows of the packed tables the kernel
    reads (the real surfaces, the materials, the active lights, misc):
    test01, test13 and demo03 run the shared-memory instantiation with
    every table there; test13 with 384 spheres added (chip_smoke.py
    crowded_scene) too, cl_f left in device memory; with 640, the
    instantiation that reads device memory."""
    sc = _crowded(int(name[5:])) if name.startswith("crowd") \
        else _scene(name)
    struct = ck.scene_struct(sc)
    assert not struct.can_push
    ps = ck.pack_scene(sc, struct, cull=False)
    ns, nl = struct.n_real, struct.nl
    want = [4 * t.numel() for t in (
        ps.sp_f[:ns], ps.sp_i[:ns], ps.cl_f[:ns], ps.mat_f, ps.mat_i,
        ps.lg_f[:nl], ps.misc)]
    core = 16 + sum(-(-b // 16) * 16 for k, b in enumerate(want) if k != 2)
    st = ck.paths_staging(struct)
    if name == "crowd640":
        assert st is None and core > ck.PATHS_SMEM_BYTES
        return
    if name == "crowd384":
        assert core + -(-want[2] // 16) * 16 > ck.PATHS_SMEM_BYTES
        want[2] = 0
    assert st.bytes == tuple(want)
    assert st.total == 16 + sum(-(-b // 16) * 16 for b in want)


# ---- the wrapper's launch -------------------------------------------------------

@pytest.mark.parametrize("walk", ["culled", "unculled"])
def test_paths_launch_arguments(walk, monkeypatch):
    """The ctypes call of the path-record wrappers, with the library, the
    device and the stream stood in for (meta tensors take the launch
    path): the bound argument count; after the stream, the work queue (a
    one-int32 scratch tensor of the wrapper's, zeroed by the launch), the
    material rows, the per-ray masks' floor and Schlick's flag (0); the
    culling gates (none
    for trace_paths_with_struct); one launch counted."""
    sc = _scene("test13")
    struct = ck.scene_struct(sc)
    calls, scratch = [], []
    fake = types.SimpleNamespace(
        whitted_paths_launch=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(ck, "_lib", lambda: fake)
    monkeypatch.setattr(ck, "_launch_inputs", lambda fn, sc, org, dirs, t,
                        struct, ps: (torch.zeros((7, dirs.shape[0])),
                                     (0,) * 12 + (struct.ns,)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1234))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: scratch.append(
        (a, k)) or empty(*a, **k))
    meta = lambda *s: empty(s, device="meta")
    rays = (meta(3), meta(64, 3), meta(64))
    before = ck.paths_launches
    if walk == "culled":
        cols, paths = ck.trace_paths(sc, *rays, CFG, K)
        flags = ck.cull_gates(struct, CFG).flags
        assert flags != 0
    else:
        cols, paths = ck.trace_paths_with_struct(sc, struct, *rays, CFG, K)
        flags = 0
    (args,) = calls
    assert len(args) == len(ck.ARGTYPES["whitted_paths_launch"])
    assert args[-6:-4] == (flags, 1234)
    assert args[-3:] == (struct.nm, ck.EMIT_OWN_MIN_KEPT, 0)
    queue = [k for a, k in scratch if a == ((1,),)]
    assert len(queue) == 1 and queue[0]["dtype"] == torch.int32
    assert tuple(paths.shape) == (K, 64) and tuple(cols.shape) == (64, 3)
    assert ck.paths_launches == before + 1


def test_argtypes_match_the_c_entry_points():
    """ARGTYPES against the extern "C" signatures of csrc/whitted.cu (the
    scene tables' macro expanded): a pointer for each pointer parameter
    and the stream, an int for each int, a float for each float."""
    src = _source()
    scene = re.search(r"#define SCENE_PARAMS\s*\\\s*((?:[^\n]*\\\n)*[^\n]*)",
                      src).group(1).replace("\\\n", " ")
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert {name for name, _ in found} == set(ck.ARGTYPES)
    kind = {ck._VOIDP: "p", ck._INT: "i", ctypes.c_float: "f"}
    for name, params in found:
        params = params.replace("SCENE_PARAMS", scene)
        kinds = ["p" if "*" in p else "f" if "float" in p else "i"
                 for p in params.split(",")]
        assert kinds == [kind[t] for t in ck.ARGTYPES[name]], name


# ---- on the card ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _walk(sc, rays, walk):
    if walk == "culled":
        return ck.trace_paths(sc, *rays, CFG, K)
    return ck.trace_paths_with_struct(sc, ck.scene_struct(sc), *rays, CFG, K)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["culled", "unculled"])
@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("name", ["test13", "crowd384", "crowd640"])
def test_paths_edges_on_card(name, n, walk):
    """Both walks, both instantiations (test13's tables in shared memory,
    crowd384's there but cl_f, crowd640's in device memory), at the edge
    ray counts: the records equal the plain trace_paths', the colours
    within 1e-5, one launch each."""
    dev = _card()
    sc = _crowded(int(name[5:]), dev) if name.startswith("crowd") \
        else _scene(name, dev)
    assert (ck.paths_staging(ck.scene_struct(sc)) is None) == (
        name == "crowd640")
    from chip_smoke import edge_rays
    rays = edge_rays(sc, n)
    before = ck.paths_launches
    cols, paths = _walk(sc, rays, walk)
    want_c, want_p = trace_paths(
        sc, *rays, CFG if walk == "culled" else CFG._replace(cull=False), K)
    torch.cuda.synchronize()
    assert ck.paths_launches == before + 1
    assert torch.equal(paths, want_p)
    assert float((cols - want_c).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["culled", "unculled"])
@pytest.mark.parametrize("name", ["test01", "test13", "demo03"])
def test_paths_two_launches_bitwise_on_card(name, walk):
    dev = _card()
    sc = _scene(name, dev)
    from chip_smoke import edge_rays
    rays = edge_rays(sc, 800 * 480)
    a, b = _walk(sc, rays, walk), _walk(sc, rays, walk)
    torch.cuda.synchronize()
    assert torch.equal(BITS(a[0]), BITS(b[0])) and torch.equal(a[1], b[1])
