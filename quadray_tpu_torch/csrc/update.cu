// The scene update of the interactive frame for NVIDIA Hopper (sm_90a):
// the transform-dependent fields of a later frame (scene/compile.py
// MOVED_GROUPS: s_pos, s_inv, s_fwd and s_bsph of the surfaces, l_pos of
// the lights, the camera's four vectors) from the moving nodes' local
// transforms, in one launch (update_launch). The counterpart of the JAX
// engine's per-frame update under _update_jit (quadray_tpu/engine.py:195,
// over _compile_scene_impl, quadray_tpu/scene/compile.py:635): one
// executable there, one launch here, where the port ran the plain version
// (scene/compile.py SceneStructure.moved_fields) in numpy on the host and
// copied its fields to the card.
//
// Each value is its plain version's bits (ops/_build.py NVCC_FLAGS: no
// contraction into FMA, IEEE division and sqrt, and the rounding of each
// step spelled out with intrinsics): a matrix product is _bmm's chain from
// a zero accumulator, k = 0, 1, ..., each step the float64 a * b + acc
// (the product exact) rounded once to f32; the inverse is _inv3_batch's
// f32 operations in its order; a bounding sphere is _bounding_spheres'
// (float64 sqrt rounded to f32, numpy's NaN-propagating max over the
// eight corners). sin and cos are not computed here: the host evaluates
// them with the plain version's torch float64 call (CUDA's are not
// correctly rounded) and stages, per moving node, its scale, position,
// cos and sin.
//
// Grid: one block. Its threads first compose the world matrices of the
// nodes that can move, level by level from the root (a barrier between
// levels; a thread a node, looping where nodes outnumber threads), into
// the scratch rows UpdateArgs.w; then a thread a surface row, light row or
// the camera writes the fields. A node's parent, and a surface's, light's
// or the camera's node, is a scratch row (>= 0) or, where nothing above it
// moves, a row of the structure's world matrices (-(node + 1)).
//
// What bounds it on the H100: neither bytes nor operations. A frame's
// fields are a few KB (demo03: 152 surface rows, about 13 KB) and its
// products a few thousand flops, in a chain as deep as the hierarchy; a
// launch is microseconds of latency. What the design saves is the host's
// work a frame, and it lets the update be captured in the frame's CUDA
// graph (ops/graphs.py InteractiveProgram) with the pack and the trace.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// per moving node: scale xyz, position xyz, cos xyz, sin xyz
constexpr int IN_W = 12;
constexpr float R_SCALE = 1.001f, R_PAD = 1e-4f;

}  // namespace

// The launch's arguments, passed by value (ops/update.py _UpdateArgs
// mirrors it field for field). An output pointer is null where the launch
// does not write its group.
struct UpdateArgs {
  const float* local;       // (nd, 12) the moving nodes' local transforms
  const float* l_static;    // (nn, 16) local matrices of the static nodes
  const float* w_static;    // (nn + 1, 16) world matrices of unmoved nodes
  const int* lv_start;      // (nlev + 1,) each level's scratch rows
  const int* par;           // (nq,) parent: scratch row or -(node + 1)
  const int* src;           // (nq,) local: row of local or -(node + 1)
  const int* surf;          // (nsurf,) a surface's node: as par
  const int* light;         // (nlight,) a light's node: as par
  const int* box;           // (nsurf,) its canonical box, or -1
  const float* box_ctr;     // (nbox, 3) f32 box centres
  const float* box_corners; // (nbox, 8, 3) f32 corner offsets
  float* w;                 // (nq, 16) scratch: the moving world matrices
  float* s_pos;             // (ns, 3)
  float* s_inv;             // (ns, 3, 3)
  float* s_fwd;             // (ns, 3, 3)
  float* s_bsph;            // (ns, 4)
  float* l_pos;             // (nl, 3)
  float* cam_pos;           // (3,)
  float* cam_hor;           // (3,)
  float* cam_ver;           // (3,)
  float* cam_nrm;           // (3,)
  int cam;                  // the camera's node: as par
  int nlev, nsurf, ns, nlight, nl;
};

namespace {

// one step of _bmm's chain: acc + a * b in float64, rounded to f32
__device__ __forceinline__ float mac(float a, float b, float acc) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b),
                                     (double)acc));
}

// c = a @ b, (n x n) row-major f32, as _bmm
template <int N>
__device__ __forceinline__ void matmul(const float* a, const float* b,
                                       float* c) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < N; ++k) acc = mac(a[i * N + k], b[k * N + j], acc);
      c[i * N + j] = acc;
    }
}

// transform_matrices' local matrix of one moving node: Rz . Ry . Rx . S
// (each product _bmm's), its position, and the row 0 0 0 1
__device__ __forceinline__ void local_matrix(const float* v, float* m) {
  const float sx = v[0], sy = v[1], sz = v[2];
  const float cx = v[6], cy = v[7], cz = v[8];
  const float snx = v[9], sny = v[10], snz = v[11];
  const float rx[9] = {1.0f, 0.0f, 0.0f, 0.0f, cx, -snx, 0.0f, snx, cx};
  const float ry[9] = {cy, 0.0f, sny, 0.0f, 1.0f, 0.0f, -sny, 0.0f, cy};
  const float rz[9] = {cz, -snz, 0.0f, snz, cz, 0.0f, 0.0f, 0.0f, 1.0f};
  const float sc[9] = {sx, 0.0f, 0.0f, 0.0f, sy, 0.0f, 0.0f, 0.0f, sz};
  float a[9], b[9], r[9];
  matmul<3>(rz, ry, a);
  matmul<3>(a, rx, b);
  matmul<3>(b, sc, r);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) m[i * 4 + j] = r[i * 3 + j];
    m[i * 4 + 3] = v[3 + i];
  }
  m[12] = m[13] = m[14] = 0.0f;
  m[15] = 1.0f;
}

// a world matrix: a scratch row, or a row of the structure's
__device__ __forceinline__ const float* world(const UpdateArgs& a, int ref) {
  return ref >= 0 ? a.w + ref * 16 : a.w_static + (-ref - 1) * 16;
}

// scratch row q: its parent's world matrix times its local matrix
__device__ __forceinline__ void compose(const UpdateArgs& a, int q) {
  float loc[16], wp[16], out[16];
  const int s = a.src[q];
  if (s >= 0) {
    local_matrix(a.local + s * IN_W, loc);
  } else {
    for (int k = 0; k < 16; ++k) loc[k] = a.l_static[(-s - 1) * 16 + k];
  }
  const float* p = world(a, a.par[q]);
  for (int k = 0; k < 16; ++k) wp[k] = p[k];
  matmul<4>(wp, loc, out);
  for (int k = 0; k < 16; ++k) a.w[q * 16 + k] = out[k];
}

// _inv3_batch's f32 operations in its order: the cofactors, the
// determinant left to right, each adjugate entry over it
__device__ __forceinline__ void inv3(const float* m, float* o) {
  const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5];
  const float g = m[6], h = m[7], i = m[8];
  const float A = __fsub_rn(__fmul_rn(e, i), __fmul_rn(f, h));
  const float B = __fsub_rn(__fmul_rn(f, g), __fmul_rn(d, i));
  const float C = __fsub_rn(__fmul_rn(d, h), __fmul_rn(e, g));
  const float det = __fadd_rn(
      __fadd_rn(__fmul_rn(a, A), __fmul_rn(b, B)), __fmul_rn(c, C));
  const float adj[9] = {
      A, __fsub_rn(__fmul_rn(c, h), __fmul_rn(b, i)),
      __fsub_rn(__fmul_rn(b, f), __fmul_rn(c, e)),
      B, __fsub_rn(__fmul_rn(a, i), __fmul_rn(c, g)),
      __fsub_rn(__fmul_rn(c, d), __fmul_rn(a, f)),
      C, __fsub_rn(__fmul_rn(b, g), __fmul_rn(a, h)),
      __fsub_rn(__fmul_rn(a, e), __fmul_rn(b, d))};
  for (int k = 0; k < 9; ++k) o[k] = __fdiv_rn(adj[k], det);
}

// _bounding_spheres' row of one bounded surface: the box centre through
// the linear map plus the position, and the squared padded radius of the
// farthest corner (a NaN anywhere among the corners gives NaN, as np.max)
__device__ __forceinline__ void bounding_sphere(const float* lin,
                                                const float* pos,
                                                const float* ctr,
                                                const float* corners,
                                                float* o) {
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
    for (int k = 0; k < 3; ++k) acc = mac(lin[c * 3 + k], ctr[k], acc);
    o[c] = __fadd_rn(acc, pos[c]);
  }
  float r2 = 0.0f;
  for (int j = 0; j < 8; ++j) {
    float sq[3];
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
      for (int k = 0; k < 3; ++k)
        acc = mac(corners[j * 3 + k], lin[c * 3 + k], acc);
      sq[c] = __fmul_rn(acc, acc);
    }
    const float s = __fadd_rn(__fadd_rn(sq[0], sq[1]), sq[2]);
    if (j == 0 || (r2 == r2 && (s != s || s > r2))) r2 = s;
  }
  float r = __double2float_rn(__dsqrt_rn((double)r2));
  r = __fadd_rn(__fmul_rn(r, R_SCALE), R_PAD);
  o[3] = __fmul_rn(r, r);
}

// surface row i: zeros past the scene's surfaces; s_bsph zero where the
// surface has no box
__device__ __forceinline__ void surface_row(const UpdateArgs& a, int i) {
  float lin[9] = {}, pos[3] = {}, inv[9] = {}, bs[4] = {};
  if (i < a.nsurf) {
    const float* m = world(a, a.surf[i]);
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) lin[r * 3 + c] = m[r * 4 + c];
      pos[r] = m[r * 4 + 3];
    }
    inv3(lin, inv);
    const int b = a.box[i];
    if (b >= 0)
      bounding_sphere(lin, pos, a.box_ctr + b * 3, a.box_corners + b * 24,
                      bs);
  }
  for (int k = 0; k < 3; ++k) a.s_pos[i * 3 + k] = pos[k];
  for (int k = 0; k < 9; ++k) {
    a.s_inv[i * 9 + k] = inv[k];
    a.s_fwd[i * 9 + k] = lin[k];
  }
  for (int k = 0; k < 4; ++k) a.s_bsph[i * 4 + k] = bs[k];
}

// the block's work: the scratch world matrices level by level, then the
// rows of the groups whose outputs are given
__device__ __forceinline__ void update_block(const UpdateArgs& a, int t,
                                             int nt) {
  for (int lv = 0; lv < a.nlev; ++lv) {
    for (int q = a.lv_start[lv] + t; q < a.lv_start[lv + 1]; q += nt)
      compose(a, q);
    __syncthreads();
  }
  const int ns = a.s_pos ? a.ns : 0;
  const int nl = a.l_pos ? a.nl : 0;
  const int ncam = a.cam_pos ? 1 : 0;
  for (int i = t; i < ns + nl + ncam; i += nt) {
    if (i < ns) {
      surface_row(a, i);
    } else if (i < ns + nl) {
      const int l = i - ns;
      for (int k = 0; k < 3; ++k)
        a.l_pos[l * 3 + k] =
            l < a.nlight ? world(a, a.light[l])[k * 4 + 3] : 0.0f;
    } else {
      const float* m = world(a, a.cam);
      for (int k = 0; k < 3; ++k) {
        a.cam_pos[k] = m[k * 4 + 3];
        a.cam_hor[k] = m[k * 4 + 0];
        a.cam_ver[k] = m[k * 4 + 1];
        a.cam_nrm[k] = m[k * 4 + 2];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) update_kernel(const UpdateArgs a) {
  update_block(a, (int)threadIdx.x, (int)blockDim.x);
}

}  // namespace

// One launch on ``stream``; no allocation, no sync, so a CUDA graph may
// capture it. Returns the first CUDA error (0 if none).
extern "C" int update_launch(const UpdateArgs* args, void* stream) {
  update_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
