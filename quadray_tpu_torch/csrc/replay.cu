// Replay's kernels for NVIDIA Hopper (sm_90a): the row gathers and their
// backward, and (in the second half of the file) the fused replay, forward
// and backward, whose row gradients the gathers' backward sums.
//
// Trace-replay training (ops/replay.py replay_color) looks up, once a
// path segment, each ray's row of the surface table (19 floats: pos,
// inv, sci, scjh, sciw) and of the material table (10 floats: col, dff,
// spc, pow, rfl, trn, rfr, ext), and the integer kind and property bits.
// The JAX reference does this with a one-hot contraction
// (quadray_tpu/ops/replay.py:107-135, _onehot/_rows/_irow) because the
// backward of a take is a serialized scatter-add; these two kernels are
// that design's counterpart here, without a matrix product:
//
//   row_gather_launch            the forward: a thread a ray writes its
//                                29 float rows and 3 integer fields in
//                                (F, N) layout (coalesced), one launch a
//                                segment for both tables;
//   row_gather_backward_launch   the backward: the gradient (F, N) of the
//                                gathered rows summed into (F, NT) for
//                                each table, with no atomics, in the fixed
//                                order below; two launches a segment.
//
// Their plain versions are ops/row_gather.py gather_plain (index_select)
// and row_sum_plain, which sums in this very order, so kernel and plain
// version agree bit for bit and two launches on the same input give the
// same bits.
//
// The order of the backward sum, for one table row r and one float row f
// (ids: the row id of each ray; g: the gradient of the gathered rows):
//   1. tile: 32 consecutive rays (tile t = rays 32t .. 32t+31). Each of
//      the 32 leaves is g[f][i] where ids[i] == r and +0.0 elsewhere (and
//      past the last ray); the tile's sum is the xor butterfly over the
//      lanes, x[p] + x[p + h] for h = 16, 8, 4, 2, 1;
//   2. warp: TILES = 8 consecutive tiles; from +0.0, the tiles' sums
//      added one after the other in tile order;
//   3. block: WARPS = 4 consecutive warps (CHUNK = 1024 rays); from +0.0,
//      the warps' sums in warp order;
//   4. table: from +0.0, the blocks' sums in block order.
// A sum that starts at +0.0 can never become -0.0, so adding a tile, warp
// or block in which r does not occur (+0.0) changes no bit: the kernel
// skips them, the plain version adds them.
//
// Design. The first backward launch is a grid of (blocks of 1024 rays) x
// (bands of BAND = 64 table rows of either table). A warp walks its 8
// tiles; for each distinct row of its band in a tile (a ballot loop) all
// 32 lanes run the butterfly of every float row, and lane f adds float
// row f's total into the warp's own accumulator in shared memory, so no
// two threads ever add into one address. The block then adds its warps'
// accumulators in warp order into its partial [block][F][NT] in device
// memory. The second launch has a thread a (f, r) of each table add the
// blocks' partials in block order. Every table height the 12-bit record
// id allows (up to 4096 rows) takes this one path; a band of a table
// reads the ray ids of every block.
//
// What bounds them on the H100: bytes. The forward writes 29 floats and 3
// ints a ray and reads 5 bytes of ids (the tables stay in L1/L2); the
// backward reads 29 gradient floats and two ids a ray, 47.6 MB a segment
// at 384,000 rays: 0.0142 ms at 3.35 TB/s. No FMA and no reassociation
// touch the sums (ops/_build.py NVCC_FLAGS: --fmad=false).

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int WARPS = 4;                       // warps a backward block
constexpr int TILES = 8;                       // tiles of 32 rays a warp
constexpr int CHUNK = WARPS * TILES * WARP;    // rays a backward block
constexpr int BAND = 64;                       // table rows a backward block
constexpr int SF = 19, MF = 10;                // surface / material floats
constexpr int FWD_THREADS = 256;
constexpr int SUM_THREADS = 256;
constexpr int SUM_AHEAD = 32;                  // loads in flight, ordered_sum

__global__ void gather_kernel(const float* __restrict__ stab,
                              const float* __restrict__ mtab,
                              const int* __restrict__ s_kind,
                              const int* __restrict__ s_mat,
                              const int* __restrict__ m_props,
                              const int* __restrict__ srf,
                              const unsigned char* __restrict__ sidep,
                              float* __restrict__ srows,
                              float* __restrict__ mrows,
                              int* __restrict__ midx, int* __restrict__ skind,
                              int* __restrict__ props, int n, int ns, int nm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = srf[i];
  // an id off the table stops the launch, as index_select's device-side
  // check does
  if (s < 0 || s >= ns) __trap();
  const int m = __ldg(s_mat + 2 * s + (sidep[i] ? 0 : 1));
  if (m < 0 || m >= nm) __trap();
#pragma unroll
  for (int f = 0; f < SF; ++f)
    srows[(size_t)f * n + i] = __ldg(stab + (size_t)f * ns + s);
#pragma unroll
  for (int f = 0; f < MF; ++f)
    mrows[(size_t)f * n + i] = __ldg(mtab + (size_t)f * nm + m);
  midx[i] = m;
  skind[i] = __ldg(s_kind + s);
  props[i] = __ldg(m_props + m);
}

// One block's partial of one band [r0, r0 + BAND) of a table of F float
// rows and nt table rows: steps 1-3 of the order in the file header.
template <int F>
__device__ __forceinline__ void band_partial(const float* __restrict__ g,
                                             const int* __restrict__ ids,
                                             float* __restrict__ part, int n,
                                             int nt, int r0, float* acc) {
  const int lane = threadIdx.x & (WARP - 1);
  const int w = threadIdx.x / WARP;
  for (int k = threadIdx.x; k < WARPS * F * BAND; k += blockDim.x)
    acc[k] = 0.0f;
  __syncthreads();
  float* mine = acc + w * F * BAND;
  const int base = blockIdx.x * CHUNK + w * TILES * WARP;
  for (int t = 0; t < TILES; ++t) {
    const int i = base + t * WARP + lane;
    int key = -1;
    if (i < n) {
      const int r = ids[i] - r0;
      if (r >= 0 && r < BAND) key = r;
    }
    unsigned todo = __ballot_sync(FULL, key >= 0);
    if (todo == 0) continue;
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = key >= 0 ? g[(size_t)f * n + i] : 0.0f;
    while (todo) {
      const int r = __shfl_sync(FULL, key, __ffs(todo) - 1);
      const bool on = key == r;
      todo &= ~__ballot_sync(FULL, on);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float x = on ? v[f] : 0.0f;
#pragma unroll
        for (int h = WARP / 2; h >= 1; h /= 2)
          x += __shfl_xor_sync(FULL, x, h);
        if (lane == f) mine[f * BAND + r] += x;
      }
    }
  }
  __syncthreads();
  const int rows = min(BAND, nt - r0);
  for (int k = threadIdx.x; k < F * rows; k += blockDim.x) {
    const int f = k / rows, r = k % rows;
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) s += acc[(u * F + f) * BAND + r];
    part[((size_t)blockIdx.x * F + f) * nt + r0 + r] = s;
  }
}

// blockIdx.y: the surface table's bands, then the material table's
__global__ void __launch_bounds__(WARPS * WARP)
    partial_kernel(const float* __restrict__ g_s, const float* __restrict__ g_m,
                   const int* __restrict__ srf, const int* __restrict__ midx,
                   float* __restrict__ part_s, float* __restrict__ part_m,
                   int n, int ns, int nm, int bands_s) {
  __shared__ float acc[WARPS * SF * BAND];
  const int band = blockIdx.y;
  if (band < bands_s)
    band_partial<SF>(g_s, srf, part_s, n, ns, band * BAND, acc);
  else
    band_partial<MF>(g_m, midx, part_m, n, nm, (band - bands_s) * BAND, acc);
}

// 0 + p[0] + p[stride] + ... + p[(count - 1) stride], added in that
// order; the loads of SUM_AHEAD terms are in flight at once (a chain of
// single loads waits a memory latency a term)
__device__ __forceinline__ float ordered_sum(const float* __restrict__ p,
                                             size_t stride, int count) {
  float s = 0.0f;
  int b = 0;
  for (; b + SUM_AHEAD <= count; b += SUM_AHEAD) {
    float v[SUM_AHEAD];
#pragma unroll
    for (int u = 0; u < SUM_AHEAD; ++u) v[u] = p[(size_t)(b + u) * stride];
#pragma unroll
    for (int u = 0; u < SUM_AHEAD; ++u) s += v[u];
  }
  for (; b < count; ++b) s += p[(size_t)b * stride];
  return s;
}

// step 4: a thread a (f, r) of either table adds the blocks' partials in
// block order
__global__ void table_kernel(const float* __restrict__ part_s,
                             const float* __restrict__ part_m,
                             float* __restrict__ out_s,
                             float* __restrict__ out_m, int blocks, int ns,
                             int nm) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  const float* part = part_s;
  float* out = out_s;
  int f_rows = SF, nt = ns;
  if (k >= SF * ns) {
    k -= SF * ns;
    part = part_m, out = out_m, f_rows = MF, nt = nm;
    if (k >= MF * nm) return;
  }
  const int f = k / nt, r = k % nt;
  out[(size_t)f * nt + r] =
      ordered_sum(part + (size_t)f * nt + r, (size_t)f_rows * nt, blocks);
}

}  // namespace

// The forward: srows (19, n), mrows (10, n) f32; midx, skind, props (n,)
// i32. stab (19, ns), mtab (10, nm) f32; s_kind (ns,), s_mat (ns, 2),
// m_props (nm,) i32; srf (n,) i32, sidep (n,) bool. Returns the CUDA
// error of the launch.
extern "C" int row_gather_launch(const float* stab, const float* mtab,
                                 const int* s_kind, const int* s_mat,
                                 const int* m_props, const int* srf,
                                 const unsigned char* sidep, float* srows,
                                 float* mrows, int* midx, int* skind,
                                 int* props, int n, int ns, int nm,
                                 void* stream) {
  if (n <= 0) return 0;
  gather_kernel<<<(n + FWD_THREADS - 1) / FWD_THREADS, FWD_THREADS, 0,
                  (cudaStream_t)stream>>>(stab, mtab, s_kind, s_mat, m_props,
                                          srf, sidep, srows, mrows, midx,
                                          skind, props, n, ns, nm);
  return (int)cudaGetLastError();
}

// The backward: out_s (19, ns) and out_m (10, nm) f32 from g_s (19, n)
// and g_m (10, n), the row ids srf and midx (n,) i32, through the
// partials part_s (blocks, 19, ns) and part_m (blocks, 10, nm), blocks =
// ceil(n / 1024). A table of height 0 is skipped (its gradient is not
// wanted). Returns the CUDA error of the launches.
extern "C" int row_gather_backward_launch(const float* g_s, const float* g_m,
                                          const int* srf, const int* midx,
                                          float* part_s, float* part_m,
                                          float* out_s, float* out_m, int n,
                                          int ns, int nm, void* stream) {
  if (ns < 0 || nm < 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (n + CHUNK - 1) / CHUNK;
  const int bands_s = (ns + BAND - 1) / BAND;
  const int bands_m = (nm + BAND - 1) / BAND;
  if (blocks > 0 && bands_s + bands_m > 0) {
    partial_kernel<<<dim3(blocks, bands_s + bands_m), WARPS * WARP, 0, st>>>(
        g_s, g_m, srf, midx, part_s, part_m, n, ns, nm, bands_s);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int outs = SF * ns + MF * nm;
  if (outs > 0)
    table_kernel<<<(outs + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                   st>>>(part_s, part_m, out_s, out_m, blocks, ns, nm);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fused replay: replay_color's colors and their gradient in one forward
// and one backward launch for all K segments (ops/replay.py
// replay_color_fused; its plain version forward_plain / backward_plain,
// which these kernels follow operation for operation, so that on the card
// the two give the same bits).
//
//   replay_forward_launch   a thread a ray runs its K segments in
//                           replay_color's f32 operations and order and
//                           writes the colors, each segment's entry state
//                           (org, dir, throughput: 9 floats) and its row
//                           ids (surface, material);
//   replay_backward_launch  a thread a ray runs the segments in reverse,
//                           recomputes each from its saved state and applies
//                           the adjoint written out by hand (ops/replay.py
//                           _adjoint, line for line); it writes the
//                           segment's 19 + 10 row gradients in (F, K*N)
//                           layout, which row_gather_backward_launch then
//                           sums per table row in its own fixed order, and
//                           reduces the lights' and ambient's gradients
//                           without atomics: per segment an xor butterfly
//                           over each warp's lanes added into the warp's
//                           accumulator in shared memory, at the end the
//                           block's warps in order into a partial a block;
//                           light_group_kernel adds the blocks' partials in
//                           block order, 32 blocks a group, and
//                           light_sum_kernel the groups in group order.
//
// A ray's segment is live where it hit or continued; a warp whose rays
// are all dead on a segment skips it (its row gradients +0.0, its state
// gradient passed through), and dead lanes of a live warp compute along
// and are masked, as the plain version's torch.where is.
//
// What bounds them on the H100: bytes. At 384,000 rays and K = 8 the
// forward writes the state and ids (11 words a ray a segment, 135 MB) and
// reads the records; the backward reads those and writes 29 row-gradient
// floats a ray a segment (356 MB); the row sums read them back. The
// arithmetic, about 5 GFLOP, is 0.07 ms at the FP32 peak. The scene tables
// (19 x NS + 10 x NM floats and the lights) are read per ray through L1:
// staging them in each block's shared memory was as fast or slower on the
// H100, every block's copy costing more than it saved. The math functions
// are those
// PyTorch's CUDA ops call: sqrtf (IEEE), rsqrtf, expf, logf, IEEE division.

namespace {

constexpr int SEG_WARPS = 4;                   // warps a fused block
constexpr int SEG_THREADS = SEG_WARPS * WARP;  // the light sums' order
constexpr int LROW = 10;                       // a light's row
constexpr int LGROUP = 32;                     // blocks a light-sum group
constexpr int SROWS = 9;                       // a segment's entry state
constexpr int MAX_PATH_LIGHTS = 16;
constexpr int P_LIGHT = 1 << 0, P_METAL = 1 << 1, P_OPAQUE = 1 << 2,
              P_REFLECT = 1 << 3, P_REFRACT = 1 << 4, P_DIFFUSE = 1 << 5,
              P_SPECULAR = 1 << 6, P_GAMMA = 1 << 8, P_FRESNEL = 1 << 9;
constexpr float BIG = 1e30f;

struct Tabs {
  const float* stab;   // (19, ns)
  const float* mtab;   // (10, nm)
  const float* ltab;   // (nl, 10)
  const float* amb;    // (3,)
  const int* s_kind;   // (ns,)
  const int* s_mat;    // (ns, 2)
  const int* m_props;  // (nm,)
  int ns, nm, nl;
};

// torch.clamp(x, min=lo), torch.maximum / minimum: NaN propagates
__device__ __forceinline__ float clampmin(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}
__device__ __forceinline__ float clampmin_grad(float x, float lo, float g) {
  return x >= lo ? g : 0.0f;
}
__device__ __forceinline__ float clip_grad(float x, float lo, float hi,
                                           float g) {
  const float m = tmax(x, lo);
  const float gm = m > hi ? 0.0f : (m == hi ? 0.5f * g : g);
  return x < lo ? 0.0f : (x == lo ? 0.5f * gm : gm);
}
__device__ __forceinline__ float sgn0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float safe_div(float num, float den, float fb) {
  const bool bad = fabsf(den) < 1e-30f;
  return bad ? fb : num / (bad ? 1.0f : den);
}
// (d num, d den) of safe_div(num, den) = q
__device__ __forceinline__ void sdiv_grad(float q, float den, float g,
                                          float& gn, float& gd) {
  const bool bad = fabsf(den) < 1e-30f;
  gn = bad ? 0.0f : g / den;
  gd = bad ? 0.0f : -(g * (q / den));
}

// a segment: ops/replay.py _segment's locals
struct Seg {
  // rows
  float px, py, pz, i00, i01, i02, i10, i11, i12, i20, i21, i22;
  float sx, sy, sz, jx, jy, jz, sw;
  float mc0_r, mc0_g, mc0_b, m_dff, m_spc, m_pow, m_rfl, m_trn, m_rfr, m_ext;
  int skind, props;
  // state
  float ox, oy, oz, dx, dy, dz;
  // geometry
  bool sidep, hit, is_pl, is_tp, b_pos, use_q;
  int kindc;
  float sf, hitf, rx, ry, rz, lx, ly, lz, ex, ey, ez, a, ux, uy, uz, b, c;
  float cross, sxz, disc0, disc, sq, sgn_b, qq, num_s, den_s, t_qd, t_pl, t;
  float hx, hy, hz, wx, wy, wz, gx, gy, gz, nrx, nry, nrz, qn, nn, nx, ny,
      nz;
  // material
  bool gam, metal, diffuse, specular, emis, refracts, fres, rf_mask;
  float mc_r, mc_g, mc_b, d2, lw0, lw;
  // Fresnel and the continuation (not after the last segment)
  float dl, rhx, rhy, rhz, dot, eta, ed, ksn, sqk, esq, rfx, rfy, rfz;
  float den_rs, rs, es, den_rp, rp, s_f, fr0, fr, c_trn, c_rfl0, rcp, ext2;
  float t2m, c2, gg, x0, x1, den_a, fa, den_b, fb, vm, vp, f_rf, c_rfl;
  bool tir, is_rfl, is_trn, cont;
  float ddn, t2d, mrx, mry, mrz, wsel;
};

__device__ __forceinline__ void load_rows(Seg& v, const Tabs& t, int s,
                                          int m) {
  const float* st = t.stab;
  const int ns = t.ns;
  v.px = __ldg(st + 0 * ns + s);
  v.py = __ldg(st + 1 * ns + s);
  v.pz = __ldg(st + 2 * ns + s);
  v.i00 = __ldg(st + 3 * ns + s);
  v.i01 = __ldg(st + 4 * ns + s);
  v.i02 = __ldg(st + 5 * ns + s);
  v.i10 = __ldg(st + 6 * ns + s);
  v.i11 = __ldg(st + 7 * ns + s);
  v.i12 = __ldg(st + 8 * ns + s);
  v.i20 = __ldg(st + 9 * ns + s);
  v.i21 = __ldg(st + 10 * ns + s);
  v.i22 = __ldg(st + 11 * ns + s);
  v.sx = __ldg(st + 12 * ns + s);
  v.sy = __ldg(st + 13 * ns + s);
  v.sz = __ldg(st + 14 * ns + s);
  v.jx = __ldg(st + 15 * ns + s);
  v.jy = __ldg(st + 16 * ns + s);
  v.jz = __ldg(st + 17 * ns + s);
  v.sw = __ldg(st + 18 * ns + s);
  const float* mt = t.mtab;
  const int nm = t.nm;
  v.mc0_r = __ldg(mt + 0 * nm + m);
  v.mc0_g = __ldg(mt + 1 * nm + m);
  v.mc0_b = __ldg(mt + 2 * nm + m);
  v.m_dff = __ldg(mt + 3 * nm + m);
  v.m_spc = __ldg(mt + 4 * nm + m);
  v.m_pow = __ldg(mt + 5 * nm + m);
  v.m_rfl = __ldg(mt + 6 * nm + m);
  v.m_trn = __ldg(mt + 7 * nm + m);
  v.m_rfr = __ldg(mt + 8 * nm + m);
  v.m_ext = __ldg(mt + 9 * nm + m);
  v.skind = __ldg(t.s_kind + s);
  v.props = __ldg(t.m_props + m);
}

__device__ __forceinline__ void segment(Seg& v, int rec, bool ug, bool uf,
                                        bool last) {
  v.sidep = ((rec >> 12) & 1) == 1;
  v.sf = v.sidep ? 1.0f : -1.0f;
  v.kindc = (rec >> 13) & 3;
  v.hit = ((rec >> 15) & 1) != 0;
  v.hitf = v.hit ? 1.0f : 0.0f;

  v.rx = v.ox - v.px;
  v.ry = v.oy - v.py;
  v.rz = v.oz - v.pz;
  v.lx = v.i00 * v.rx + v.i01 * v.ry + v.i02 * v.rz;
  v.ly = v.i10 * v.rx + v.i11 * v.ry + v.i12 * v.rz;
  v.lz = v.i20 * v.rx + v.i21 * v.ry + v.i22 * v.rz;
  v.ex = v.i00 * v.dx + v.i01 * v.dy + v.i02 * v.dz;
  v.ey = v.i10 * v.dx + v.i11 * v.dy + v.i12 * v.dz;
  v.ez = v.i20 * v.dx + v.i21 * v.dy + v.i22 * v.dz;
  v.is_pl = v.skind == 1;
  v.is_tp = v.skind == 3;
  v.a = v.sx * v.ex * v.ex + v.sy * v.ey * v.ey + v.sz * v.ez * v.ez;
  v.ux = v.sx * v.lx - v.jx;
  v.uy = v.sy * v.ly - v.jy;
  v.uz = v.sz * v.lz - v.jz;
  v.b = v.ux * v.ex + v.uy * v.ey + v.uz * v.ez;
  v.c = v.sx * v.lx * v.lx + v.sy * v.ly * v.ly + v.sz * v.lz * v.lz -
        2.0f * (v.jx * v.lx + v.jy * v.ly + v.jz * v.lz) - v.sw;
  v.cross = v.lx * v.ez - v.lz * v.ex;
  v.sxz = v.sx * v.sz;
  v.disc0 = v.is_tp ? fabsf(v.sxz) * v.cross * v.cross : v.b * v.b - v.a * v.c;
  v.disc = v.is_pl ? 1.0f : clampmin(v.disc0, 1e-20f);
  v.sq = sqrtf(v.disc);
  v.sgn_b = v.b >= 0.0f ? 1.0f : -1.0f;
  v.qq = -(v.b + v.sgn_b * v.sq);
  v.b_pos = v.b > 0.0f;
  v.use_q = v.sidep == v.b_pos;
  v.num_s = v.use_q ? v.qq : v.c;
  v.den_s = v.use_q ? v.a : v.qq;
  {
    // _root: zero numerator -> 0; zero denominator -> invalid (BIG)
    const float den = v.num_s == 0.0f ? 1.0f : v.den_s;
    const bool ok = den != 0.0f;
    v.t_qd = ok ? v.num_s / (ok ? den : 1.0f) : BIG;
  }
  v.t_pl = safe_div(-v.lz, v.ez, 0.0f);
  v.t = v.hit ? (v.is_pl ? v.t_pl : v.t_qd) : 0.0f;

  v.hx = v.lx + v.t * v.ex;
  v.hy = v.ly + v.t * v.ey;
  v.hz = v.lz + v.t * v.ez;
  v.wx = v.ox + v.t * v.dx;
  v.wy = v.oy + v.t * v.dy;
  v.wz = v.oz + v.t * v.dz;
  v.gx = v.is_pl ? 0.0f : v.sx * v.hx - v.jx;
  v.gy = v.is_pl ? 0.0f : v.sy * v.hy - v.jy;
  v.gz = v.is_pl ? 1.0f : v.sz * v.hz - v.jz;
  v.nrx = (v.i00 * v.gx + v.i10 * v.gy + v.i20 * v.gz) * v.sf;
  v.nry = (v.i01 * v.gx + v.i11 * v.gy + v.i21 * v.gz) * v.sf;
  v.nrz = (v.i02 * v.gx + v.i12 * v.gy + v.i22 * v.gz) * v.sf;
  v.qn = v.nrx * v.nrx + v.nry * v.nry + v.nrz * v.nrz;
  v.nn = rsqrtf(clampmin(v.qn, 1e-30f));
  v.nx = v.nrx * v.nn;
  v.ny = v.nry * v.nn;
  v.nz = v.nrz * v.nn;

  const int pr = v.props;
  v.gam = ((pr & P_GAMMA) != 0) && ug;
  v.mc_r = v.gam ? v.mc0_r * v.mc0_r : v.mc0_r;
  v.mc_g = v.gam ? v.mc0_g * v.mc0_g : v.mc0_g;
  v.mc_b = v.gam ? v.mc0_b * v.mc0_b : v.mc0_b;
  v.metal = (pr & P_METAL) != 0;
  v.diffuse = (pr & P_DIFFUSE) != 0;
  v.specular = (pr & P_SPECULAR) != 0;
  v.emis = (pr & P_LIGHT) != 0;
  v.refracts = (pr & P_REFRACT) != 0;
  v.fres = ((pr & P_FRESNEL) != 0) && ((pr & P_OPAQUE) == 0) && uf;
  v.rf_mask = ((pr & P_OPAQUE) != 0) && ((pr & P_REFLECT) != 0) &&
              ((pr & P_FRESNEL) != 0) && uf;
  v.d2 = v.dx * v.dx + v.dy * v.dy + v.dz * v.dz;
  v.lw0 = 1.0f - v.m_trn - v.m_rfl;
  v.lw = tmax(v.lw0, 0.0f);
  if (last) return;

  v.dl = rsqrtf(clampmin(v.d2, 1e-30f));
  v.rhx = v.dx * v.dl;
  v.rhy = v.dy * v.dl;
  v.rhz = v.dz * v.dl;
  v.dot = v.rhx * v.nx + v.rhy * v.ny + v.rhz * v.nz;
  v.eta = v.m_rfr;
  v.ed = v.eta * v.dot;
  v.ksn = 1.0f - v.eta * v.eta + v.ed * v.ed;
  v.tir = (v.ksn < 0.0f) && v.refracts;
  v.sqk = sqrtf(clampmin(v.ksn, 1e-20f));
  v.esq = v.ed + v.sqk;
  v.rfx = v.refracts ? v.eta * v.rhx - v.nx * v.esq : v.rhx;
  v.rfy = v.refracts ? v.eta * v.rhy - v.ny * v.esq : v.rhy;
  v.rfz = v.refracts ? v.eta * v.rhz - v.nz * v.esq : v.rhz;
  v.den_rs = v.ed - v.sqk;
  v.rs = safe_div(v.esq, v.den_rs, 1.0f);
  v.es = v.eta * v.sqk;
  v.den_rp = v.dot - v.es;
  v.rp = safe_div(v.dot + v.es, v.den_rp, 1.0f);
  v.s_f = v.rs * v.rs + v.rp * v.rp;
  v.fr0 = 0.5f * v.s_f;
  v.fr = v.fres ? clip(v.fr0, 0.0f, 1.0f) : 0.0f;
  v.fr = (v.tir && v.fres) ? 1.0f : v.fr;
  v.c_trn = v.tir ? 0.0f : v.m_trn * (1.0f - v.fr);
  v.c_rfl0 = v.m_rfl + v.m_trn * v.fr;
  v.rcp = safe_div(1.0f, v.m_rfr, 0.0f);
  v.ext2 = v.m_ext * v.m_ext;
  v.t2m = 2.0f * v.dot * v.rcp;
  v.c2 = v.dot * v.dot;
  v.gg = v.rcp * v.rcp + v.ext2;
  v.x0 = v.c2 + v.gg;
  v.x1 = v.c2 * v.gg + 1.0f;
  v.den_a = v.x0 - v.t2m;
  v.fa = safe_div(v.x0 + v.t2m, v.den_a, 1.0f);
  v.den_b = v.x1 - v.t2m;
  v.fb = safe_div(v.x1 + v.t2m, v.den_b, 1.0f);
  v.vm = -0.5f * (v.fa + v.fb);
  v.vp = -0.5f * v.s_f;
  v.f_rf = v.metal ? fabsf(v.vm) : fabsf(v.vp);
  v.c_rfl = v.rf_mask ? v.m_rfl * v.f_rf : v.c_rfl0;

  v.is_rfl = v.kindc == 1;
  v.is_trn = v.kindc == 2;
  v.cont = v.kindc > 0;
  v.ddn = v.dx * v.nx + v.dy * v.ny + v.dz * v.nz;
  v.t2d = 2.0f * v.ddn;
  v.mrx = v.dx - v.t2d * v.nx;
  v.mry = v.dy - v.t2d * v.ny;
  v.mrz = v.dz - v.t2d * v.nz;
  v.wsel = v.is_rfl ? v.c_rfl : (v.is_trn ? v.c_trn : 1.0f);
}

// a light's term: ops/replay.py _light's locals
struct Light {
  float lpx, lpy, lpz, lcr0, lcg0, lcb0, lon, cnt, lnr, qdr;
  float lvx, lvy, lvz, lcr, lcg, lcb, r_dot, r2, r, den, attn, dfs, t2r;
  float rlx, rly, rlz, sdot, d2r2, rs2, cosr0, cosr_s, cosr, lg, e, spc, tm;
  float mclc_r, mclc_g, mclc_b, term_r, term_g, term_b;
  bool don, spc_on;
};

__device__ __forceinline__ void light(Light& q, const Tabs& t, int l,
                                      const Seg& v, int rec) {
  const float* lt = t.ltab + l * LROW;
  q.lpx = __ldg(lt);
  q.lpy = __ldg(lt + 1);
  q.lpz = __ldg(lt + 2);
  q.lcr0 = __ldg(lt + 3);
  q.lcg0 = __ldg(lt + 4);
  q.lcb0 = __ldg(lt + 5);
  q.lon = __ldg(lt + 6);
  q.cnt = __ldg(lt + 7);
  q.lnr = __ldg(lt + 8);
  q.qdr = __ldg(lt + 9);
  // rows past the 16 recorded lights are pad rows, unshadowed
  const bool hm =
      l < MAX_PATH_LIGHTS ? ((((unsigned)rec >> (16 + l)) & 1u) == 0u) : true;
  q.lvx = q.lpx - v.wx;
  q.lvy = q.lpy - v.wy;
  q.lvz = q.lpz - v.wz;
  q.lcr = q.lcr0 * q.lon;
  q.lcg = q.lcg0 * q.lon;
  q.lcb = q.lcb0 * q.lon;
  q.r_dot = q.lvx * v.nx + q.lvy * v.ny + q.lvz * v.nz;
  q.r2 = q.lvx * q.lvx + q.lvy * q.lvy + q.lvz * q.lvz;
  q.r = sqrtf(clampmin(q.r2, 1e-30f));
  q.den = q.cnt + q.lnr * q.r + q.qdr * q.r2;
  q.attn = rsqrtf(clampmin(q.den, 1e-30f));
  q.don = hm && v.diffuse;
  q.dfs = q.don ? q.r_dot / q.r * q.attn * v.m_dff : 0.0f;
  q.t2r = 2.0f * q.r_dot;
  q.rlx = q.lvx - q.t2r * v.nx;
  q.rly = q.lvy - q.t2r * v.ny;
  q.rlz = q.lvz - q.t2r * v.nz;
  q.sdot = q.rlx * v.dx + q.rly * v.dy + q.rlz * v.dz;
  q.d2r2 = v.d2 * q.r2;
  q.rs2 = rsqrtf(clampmin(q.d2r2, 1e-30f));
  q.cosr0 = q.sdot * q.rs2;
  q.spc_on = hm && (q.sdot > 0.0f) && v.specular;
  q.cosr_s = q.spc_on ? q.cosr0 : 1.0f;
  q.cosr = clip(q.cosr_s, 1e-6f, 1.0f);
  q.lg = logf(q.cosr);
  q.e = expf(v.m_pow * q.lg);
  q.spc = q.spc_on ? q.e * v.m_spc : 0.0f;
  q.tm = q.dfs + q.spc;
  q.mclc_r = v.mc_r * q.lcr;
  q.mclc_g = v.mc_g * q.lcg;
  q.mclc_b = v.mc_b * q.lcb;
  q.term_r = v.metal ? q.mclc_r * q.tm : q.mclc_r * q.dfs + q.lcr * q.spc;
  q.term_g = v.metal ? q.mclc_g * q.tm : q.mclc_g * q.dfs + q.lcg * q.spc;
  q.term_b = v.metal ? q.mclc_b * q.tm : q.mclc_b * q.dfs + q.lcb * q.spc;
}

// the segment's color: ambient, the lights, emission (ops/replay.py _color)
__device__ __forceinline__ void color(const Seg& v, const Tabs& t, int rec,
                                      float& col_r, float& col_g,
                                      float& col_b) {
  col_r = v.mc_r * __ldg(t.amb);
  col_g = v.mc_g * __ldg(t.amb + 1);
  col_b = v.mc_b * __ldg(t.amb + 2);
  for (int l = 0; l < t.nl; ++l) {
    Light q;
    light(q, t, l, v, rec);
    col_r = col_r + q.term_r;
    col_g = col_g + q.term_g;
    col_b = col_b + q.term_b;
  }
  col_r = v.emis ? v.mc_r : col_r;
  col_g = v.emis ? v.mc_g : col_g;
  col_b = v.emis ? v.mc_b : col_b;
}

// the table ids of a record; an id off its table stops the launch, as
// index_select's device-side check does
__device__ __forceinline__ void record_rows(const Tabs& t, int rec, int& s,
                                            int& m) {
  s = rec & 0xFFF;
  if (s >= t.ns) __trap();
  m = __ldg(t.s_mat + 2 * s + ((((rec >> 12) & 1) == 1) ? 0 : 1));
  if (m < 0 || m >= t.nm) __trap();
}

// ray i's K segments: its colors, and each segment's entry state and ids
__device__ __forceinline__ void fwd_ray(const Tabs& t, bool ug, bool uf,
                        const float* __restrict__ org, int org_stride,
                        const float* __restrict__ dirs,
                        const int* __restrict__ paths, float* __restrict__ cols,
                        float* __restrict__ state, int* __restrict__ ids,
                        int i, int n, int k_segs) {
  Seg v;
  v.ox = org[(size_t)i * org_stride + 0];
  v.oy = org[(size_t)i * org_stride + 1];
  v.oz = org[(size_t)i * org_stride + 2];
  v.dx = dirs[(size_t)i * 3 + 0];
  v.dy = dirs[(size_t)i * 3 + 1];
  v.dz = dirs[(size_t)i * 3 + 2];
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  const size_t kn = (size_t)k_segs * n;
  for (int k = 0; k < k_segs; ++k) {
    const size_t at = (size_t)k * n + i;
    const int rec = paths[at];
    int s, m;
    record_rows(t, rec, s, m);
    ids[at] = s;
    ids[kn + at] = m;
    float* st = state + (size_t)k * SROWS * n + i;
    st[0 * (size_t)n] = v.ox;
    st[1 * (size_t)n] = v.oy;
    st[2 * (size_t)n] = v.oz;
    st[3 * (size_t)n] = v.dx;
    st[4 * (size_t)n] = v.dy;
    st[5 * (size_t)n] = v.dz;
    st[6 * (size_t)n] = tr;
    st[7 * (size_t)n] = tg;
    st[8 * (size_t)n] = tb;
    load_rows(v, t, s, m);
    const bool last = k + 1 == k_segs;
    segment(v, rec, ug, uf, last);
    float col_r, col_g, col_b;
    color(v, t, rec, col_r, col_g, col_b);
    acc_r = acc_r + v.hitf * tr * col_r * v.lw;
    acc_g = acc_g + v.hitf * tg * col_g * v.lw;
    acc_b = acc_b + v.hitf * tb * col_b * v.lw;
    if (last) break;
    const float ndx = v.is_rfl ? v.mrx : (v.is_trn ? v.rfx : v.dx);
    const float ndy = v.is_rfl ? v.mry : (v.is_trn ? v.rfy : v.dy);
    const float ndz = v.is_rfl ? v.mrz : (v.is_trn ? v.rfz : v.dz);
    v.dx = ndx;
    v.dy = ndy;
    v.dz = ndz;
    tr = v.cont ? tr * v.wsel : tr;
    tg = v.cont ? tg * v.wsel : tg;
    tb = v.cont ? tb * v.wsel : tb;
    v.ox = v.cont ? v.wx : v.ox;
    v.oy = v.cont ? v.wy : v.oy;
    v.oz = v.cont ? v.wz : v.oz;
  }
  cols[(size_t)i * 3 + 0] = acc_r;
  cols[(size_t)i * 3 + 1] = acc_g;
  cols[(size_t)i * 3 + 2] = acc_b;
}

// a warp's sum of x over its lanes (every lane gets it): the xor butterfly
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int h = WARP / 2; h >= 1; h /= 2) x += __shfl_xor_sync(FULL, x, h);
  return x;
}

// `count` per-lane values (masked to +0.0 off `live`) summed over the warp
// and added into the warp's accumulators acc[slot ..] (lane j adds value j)
template <int COUNT>
__device__ __forceinline__ void warp_add(const float (&x)[COUNT], bool live,
                                         float* acc) {
  const int lane = threadIdx.x & (WARP - 1);
#pragma unroll
  for (int j = 0; j < COUNT; ++j) {
    const float s = warp_sum(live ? x[j] : 0.0f);
    if (lane == j) acc[j] += s;
  }
}

struct Grads {
  float s[SF];      // the surface row's
  float m[MF];      // the material row's
  float st[SROWS];  // the entry state's
};

// ops/replay.py _adjoint, line for line; the lights' and ambient's
// gradients go to the warp's accumulators (lacc) as they are made
__device__ __forceinline__ void adjoint(const Seg& v, const Tabs& t, int rec,
                        float tr, float tg, float tb, float col_r, float col_g,
                        float col_b, float gar, float gag, float gab,
                        const float (&gn)[SROWS], bool last, bool live,
                        float* lacc, Grads& out) {
  const float dx = v.dx, dy = v.dy, dz = v.dz, nx = v.nx, ny = v.ny,
              nz = v.nz;
  float gox = 0.0f, goy = 0.0f, goz = 0.0f, gwx = 0.0f, gwy = 0.0f,
        gwz = 0.0f;
  float gnx = 0.0f, gny = 0.0f, gnz = 0.0f, gdx = 0.0f, gdy = 0.0f,
        gdz = 0.0f;
  float gtr = 0.0f, gtg = 0.0f, gtb = 0.0f;
  float g_rfl = 0.0f, g_trn = 0.0f, g_ext = 0.0f, g_rfr = 0.0f, g_d2 = 0.0f;
  if (!last) {
    const float gox_n = gn[0], goy_n = gn[1], goz_n = gn[2], gdx_n = gn[3],
                gdy_n = gn[4], gdz_n = gn[5], gtr_n = gn[6], gtg_n = gn[7],
                gtb_n = gn[8];
    gwx = v.cont ? gox_n : 0.0f;
    gwy = v.cont ? goy_n : 0.0f;
    gwz = v.cont ? goz_n : 0.0f;
    gox = v.cont ? 0.0f : gox_n;
    goy = v.cont ? 0.0f : goy_n;
    goz = v.cont ? 0.0f : goz_n;
    gtr = v.cont ? gtr_n * v.wsel : gtr_n;
    gtg = v.cont ? gtg_n * v.wsel : gtg_n;
    gtb = v.cont ? gtb_n * v.wsel : gtb_n;
    const float gwsel = v.cont ? gtr_n * tr + gtg_n * tg + gtb_n * tb : 0.0f;
    const float g_crfl = v.is_rfl ? gwsel : 0.0f;
    const float g_ctrn = v.is_rfl ? 0.0f : (v.is_trn ? gwsel : 0.0f);
    const float gmrx = v.is_rfl ? gdx_n : 0.0f;
    const float gmry = v.is_rfl ? gdy_n : 0.0f;
    const float gmrz = v.is_rfl ? gdz_n : 0.0f;
    const float grfx = v.is_rfl ? 0.0f : (v.is_trn ? gdx_n : 0.0f);
    const float grfy = v.is_rfl ? 0.0f : (v.is_trn ? gdy_n : 0.0f);
    const float grfz = v.is_rfl ? 0.0f : (v.is_trn ? gdz_n : 0.0f);
    const bool keep = !(v.is_rfl || v.is_trn);
    gdx = (keep ? gdx_n : 0.0f) + gmrx;
    gdy = (keep ? gdy_n : 0.0f) + gmry;
    gdz = (keep ? gdz_n : 0.0f) + gmrz;
    const float gddn = -2.0f * (gmrx * nx + gmry * ny + gmrz * nz);
    gnx = gddn * dx - v.t2d * gmrx;
    gny = gddn * dy - v.t2d * gmry;
    gnz = gddn * dz - v.t2d * gmrz;
    gdx = gdx + gddn * nx;
    gdy = gdy + gddn * ny;
    gdz = gdz + gddn * nz;

    const float g_frf = v.rf_mask ? g_crfl * v.m_rfl : 0.0f;
    const float g_crfl0 = v.rf_mask ? 0.0f : g_crfl;
    g_rfl = (v.rf_mask ? g_crfl * v.f_rf : 0.0f) + g_crfl0;
    float g_fr = g_crfl0 * v.m_trn;
    g_trn = g_crfl0 * v.fr;
    g_trn = g_trn + (v.tir ? 0.0f : g_ctrn * (1.0f - v.fr));
    g_fr = g_fr - (v.tir ? 0.0f : g_ctrn * v.m_trn);
    const float g_fr0 =
        clip_grad(v.fr0, 0.0f, 1.0f, (v.fres && !v.tir) ? g_fr : 0.0f);
    float g_sf = 0.5f * g_fr0;
    const float g_vm = (v.metal ? g_frf : 0.0f) * sgn0(v.vm);
    g_sf = g_sf + -0.5f * ((v.metal ? 0.0f : g_frf) * sgn0(v.vp));
    const float g_fab = -0.5f * g_vm;
    float gna, gda, gnb, gdb;
    sdiv_grad(v.fa, v.den_a, g_fab, gna, gda);
    sdiv_grad(v.fb, v.den_b, g_fab, gnb, gdb);
    const float gx0 = gna + gda;
    const float gx1 = gnb + gdb;
    const float gt2m = (gna - gda) + (gnb - gdb);
    const float gc2 = gx1 * v.gg + gx0;
    const float ggg = gx1 * v.c2 + gx0;
    const float grcp = 2.0f * ggg * v.rcp + gt2m * (2.0f * v.dot);
    g_ext = 2.0f * ggg * v.m_ext;
    float gdot = 2.0f * gc2 * v.dot + 2.0f * (gt2m * v.rcp);
    float unused;
    sdiv_grad(v.rcp, v.m_rfr, grcp, unused, g_rfr);
    const float grs = 2.0f * g_sf * v.rs;
    const float grp = 2.0f * g_sf * v.rp;
    float gns, gds, gnp, gdp;
    sdiv_grad(v.rs, v.den_rs, grs, gns, gds);
    float ged = gns + gds;
    float gsqk = gns - gds;
    sdiv_grad(v.rp, v.den_rp, grp, gnp, gdp);
    gdot = gdot + (gnp + gdp);
    const float ges = gnp - gdp;
    float geta = ges * v.sqk;
    gsqk = gsqk + ges * v.eta;
    const float gqx = v.refracts ? grfx : 0.0f;
    const float gqy = v.refracts ? grfy : 0.0f;
    const float gqz = v.refracts ? grfz : 0.0f;
    float grhx = (v.refracts ? 0.0f : grfx) + v.eta * gqx;
    float grhy = (v.refracts ? 0.0f : grfy) + v.eta * gqy;
    float grhz = (v.refracts ? 0.0f : grfz) + v.eta * gqz;
    geta = geta + (gqx * v.rhx + gqy * v.rhy + gqz * v.rhz);
    const float gesq = -(gqx * nx + gqy * ny + gqz * nz);
    gnx = gnx - gqx * v.esq;
    gny = gny - gqy * v.esq;
    gnz = gnz - gqz * v.esq;
    ged = ged + gesq;
    gsqk = gsqk + gesq;
    const float gksn = clampmin_grad(v.ksn, 1e-20f, gsqk / (2.0f * v.sqk));
    geta = geta - 2.0f * gksn * v.eta;
    ged = ged + 2.0f * gksn * v.ed;
    geta = geta + ged * v.dot;
    gdot = gdot + ged * v.eta;
    g_rfr = g_rfr + geta;
    grhx = grhx + gdot * nx;
    grhy = grhy + gdot * ny;
    grhz = grhz + gdot * nz;
    gnx = gnx + gdot * v.rhx;
    gny = gny + gdot * v.rhy;
    gnz = gnz + gdot * v.rhz;
    gdx = gdx + grhx * v.dl;
    gdy = gdy + grhy * v.dl;
    gdz = gdz + grhz * v.dl;
    const float gdl = grhx * dx + grhy * dy + grhz * dz;
    g_d2 = clampmin_grad(v.d2, 1e-30f, -0.5f * gdl * (v.dl * v.dl * v.dl));
  }

  const float htr = v.hitf * tr, htg = v.hitf * tg, htb = v.hitf * tb;
  const float glw = gar * (htr * col_r) + gag * (htg * col_g) +
                    gab * (htb * col_b);
  float gcr = gar * v.lw * htr;
  float gcg = gag * v.lw * htg;
  float gcb = gab * v.lw * htb;
  gtr = gtr + gar * v.lw * col_r * v.hitf;
  gtg = gtg + gag * v.lw * col_g * v.hitf;
  gtb = gtb + gab * v.lw * col_b * v.hitf;
  const float glw0 = v.lw0 < 0.0f ? 0.0f : (v.lw0 == 0.0f ? 0.5f * glw : glw);
  g_trn = g_trn - glw0;
  g_rfl = g_rfl - glw0;
  float gmr = v.emis ? gcr : 0.0f;
  float gmg = v.emis ? gcg : 0.0f;
  float gmb = v.emis ? gcb : 0.0f;
  gcr = v.emis ? 0.0f : gcr;
  gcg = v.emis ? 0.0f : gcg;
  gcb = v.emis ? 0.0f : gcb;
  float g_dff = 0.0f, g_spc = 0.0f, g_pow = 0.0f;
  for (int l = 0; l < t.nl; ++l) {
    Light q;
    light(q, t, l, v, rec);
    const float gqr = v.metal ? gcr * q.tm : gcr * q.dfs;
    const float gqg = v.metal ? gcg * q.tm : gcg * q.dfs;
    const float gqb = v.metal ? gcb * q.tm : gcb * q.dfs;
    const float gdfs = gcr * q.mclc_r + gcg * q.mclc_g + gcb * q.mclc_b;
    const float gspc =
        v.metal ? gdfs : gcr * q.lcr + gcg * q.lcg + gcb * q.lcb;
    const float glcr = (v.metal ? 0.0f : gcr * q.spc) + gqr * v.mc_r;
    const float glcg = (v.metal ? 0.0f : gcg * q.spc) + gqg * v.mc_g;
    const float glcb = (v.metal ? 0.0f : gcb * q.spc) + gqb * v.mc_b;
    gmr = gmr + gqr * q.lcr;
    gmg = gmg + gqg * q.lcg;
    gmb = gmb + gqb * q.lcb;
    const float g_on = glcr * q.lcr0 + glcg * q.lcg0 + glcb * q.lcb0;
    const float ge = q.spc_on ? gspc * v.m_spc : 0.0f;
    g_spc = g_spc + (q.spc_on ? gspc * q.e : 0.0f);
    const float gy = ge * q.e;
    g_pow = g_pow + gy * q.lg;
    const float gcos = gy * v.m_pow / q.cosr;
    const float gcos0 =
        q.spc_on ? clip_grad(q.cosr_s, 1e-6f, 1.0f, gcos) : 0.0f;
    const float gsdot = gcos0 * q.rs2;
    const float gd2r2 = clampmin_grad(
        q.d2r2, 1e-30f, -0.5f * (gcos0 * q.sdot) * (q.rs2 * q.rs2 * q.rs2));
    g_d2 = g_d2 + gd2r2 * q.r2;
    float gr2 = gd2r2 * v.d2;
    const float grlx = gsdot * dx;
    const float grly = gsdot * dy;
    const float grlz = gsdot * dz;
    gdx = gdx + gsdot * q.rlx;
    gdy = gdy + gsdot * q.rly;
    gdz = gdz + gsdot * q.rlz;
    float grdot = -2.0f * (grlx * nx + grly * ny + grlz * nz);
    gnx = gnx - q.t2r * grlx;
    gny = gny - q.t2r * grly;
    gnz = gnz - q.t2r * grlz;
    const float a1 = q.r_dot / q.r;
    const float a2 = a1 * q.attn;
    g_dff = g_dff + (q.don ? gdfs * a2 : 0.0f);
    const float ga2 = q.don ? gdfs * v.m_dff : 0.0f;
    const float ga1 = ga2 * q.attn;
    const float gattn = ga2 * a1;
    grdot = grdot + ga1 / q.r;
    float gr = -(ga1 * (a1 / q.r));
    const float gden = clampmin_grad(
        q.den, 1e-30f, -0.5f * gattn * (q.attn * q.attn * q.attn));
    gr = gr + gden * q.lnr;
    gr2 = gr2 + gden * q.qdr;
    gr2 = gr2 + clampmin_grad(q.r2, 1e-30f, gr / (2.0f * q.r));
    const float glvx = grlx + 2.0f * gr2 * q.lvx + grdot * nx;
    const float glvy = grly + 2.0f * gr2 * q.lvy + grdot * ny;
    const float glvz = grlz + 2.0f * gr2 * q.lvz + grdot * nz;
    gnx = gnx + grdot * q.lvx;
    gny = gny + grdot * q.lvy;
    gnz = gnz + grdot * q.lvz;
    gwx = gwx - glvx;
    gwy = gwy - glvy;
    gwz = gwz - glvz;
    const float gl[LROW] = {glvx, glvy, glvz, glcr * q.lon, glcg * q.lon,
                            glcb * q.lon, g_on, gden, gden * q.r,
                            gden * q.r2};
    warp_add<LROW>(gl, live, lacc + l * LROW);
  }
  {
    const float ga[3] = {gcr * v.mc_r, gcg * v.mc_g, gcb * v.mc_b};
    warp_add<3>(ga, live, lacc + t.nl * LROW);
  }
  gmr = gmr + gcr * __ldg(t.amb);
  gmg = gmg + gcg * __ldg(t.amb + 1);
  gmb = gmb + gcb * __ldg(t.amb + 2);
  gmr = v.gam ? 2.0f * gmr * v.mc0_r : gmr;
  gmg = v.gam ? 2.0f * gmg * v.mc0_g : gmg;
  gmb = v.gam ? 2.0f * gmb * v.mc0_b : gmb;
  gdx = gdx + 2.0f * g_d2 * dx;
  gdy = gdy + 2.0f * g_d2 * dy;
  gdz = gdz + 2.0f * g_d2 * dz;

  float gnrx = gnx * v.nn;
  float gnry = gny * v.nn;
  float gnrz = gnz * v.nn;
  const float gnn = gnx * v.nrx + gny * v.nry + gnz * v.nrz;
  const float gqn =
      clampmin_grad(v.qn, 1e-30f, -0.5f * gnn * (v.nn * v.nn * v.nn));
  gnrx = gnrx + 2.0f * gqn * v.nrx;
  gnry = gnry + 2.0f * gqn * v.nry;
  gnrz = gnrz + 2.0f * gqn * v.nrz;
  const float gmx = gnrx * v.sf;
  const float gmy = gnry * v.sf;
  const float gmz = gnrz * v.sf;
  float gi00 = gmx * v.gx, gi10 = gmx * v.gy, gi20 = gmx * v.gz;
  float gi01 = gmy * v.gx, gi11 = gmy * v.gy, gi21 = gmy * v.gz;
  float gi02 = gmz * v.gx, gi12 = gmz * v.gy, gi22 = gmz * v.gz;
  const float ggx = v.is_pl ? 0.0f : v.i00 * gmx + v.i01 * gmy + v.i02 * gmz;
  const float ggy = v.is_pl ? 0.0f : v.i10 * gmx + v.i11 * gmy + v.i12 * gmz;
  const float ggz = v.is_pl ? 0.0f : v.i20 * gmx + v.i21 * gmy + v.i22 * gmz;
  float gsx = ggx * v.hx;
  float gsy = ggy * v.hy;
  float gsz = ggz * v.hz;
  const float ghx = ggx * v.sx;
  const float ghy = ggy * v.sy;
  const float ghz = ggz * v.sz;
  float gjx = -ggx;
  float gjy = -ggy;
  float gjz = -ggz;
  gox = gox + gwx;
  goy = goy + gwy;
  goz = goz + gwz;
  const float gt =
      (gwx * dx + gwy * dy + gwz * dz) + (ghx * v.ex + ghy * v.ey + ghz * v.ez);
  gdx = gdx + v.t * gwx;
  gdy = gdy + v.t * gwy;
  gdz = gdz + v.t * gwz;
  float glx = ghx, gly = ghy, glz = ghz;
  float gex = v.t * ghx;
  float gey = v.t * ghy;
  float gez = v.t * ghz;
  const float gth = v.hit ? gt : 0.0f;
  const float gtpl = v.is_pl ? gth : 0.0f;
  const float gtqd = v.is_pl ? 0.0f : gth;
  float gnum, gden_pl;
  sdiv_grad(v.t_pl, v.ez, gtpl, gnum, gden_pl);
  glz = glz - gnum;
  gez = gez + gden_pl;
  const bool num0 = v.num_s == 0.0f;
  const float den2 = num0 ? 1.0f : v.den_s;
  const bool ok = den2 != 0.0f;
  const float gnum_r = ok ? gtqd / den2 : 0.0f;
  const float gden_r = num0 ? 0.0f : (ok ? -(gtqd * (v.t_qd / den2)) : 0.0f);
  const float gqq = v.use_q ? gnum_r : gden_r;
  float gc = v.use_q ? 0.0f : gnum_r;
  float ga = v.use_q ? gden_r : 0.0f;
  float gb = -gqq;
  const float gsq = -(gqq * v.sgn_b);
  const float gdisc =
      v.is_pl ? 0.0f : clampmin_grad(v.disc0, 1e-20f, gsq / (2.0f * v.sq));
  const float gdtp = v.is_tp ? gdisc : 0.0f;
  const float gdq = v.is_tp ? 0.0f : gdisc;
  const float av = fabsf(v.sxz);
  const float gcross = 2.0f * gdtp * (av * v.cross);
  const float gsxz = gdtp * (v.cross * v.cross) * sgn0(v.sxz);
  gsx = gsx + gsxz * v.sz;
  gsz = gsz + gsxz * v.sx;
  glx = glx + gcross * v.ez;
  gez = gez + gcross * v.lx;
  glz = glz - gcross * v.ex;
  gex = gex - gcross * v.lz;
  gb = gb + 2.0f * gdq * v.b;
  ga = ga - gdq * v.c;
  gc = gc - gdq * v.a;
  gsx = gsx + ga * v.ex * v.ex;
  gsy = gsy + ga * v.ey * v.ey;
  gsz = gsz + ga * v.ez * v.ez;
  gex = gex + 2.0f * ga * v.sx * v.ex;
  gey = gey + 2.0f * ga * v.sy * v.ey;
  gez = gez + 2.0f * ga * v.sz * v.ez;
  const float gux = gb * v.ex;
  const float guy = gb * v.ey;
  const float guz = gb * v.ez;
  gex = gex + gb * v.ux;
  gey = gey + gb * v.uy;
  gez = gez + gb * v.uz;
  gsx = gsx + gux * v.lx;
  gsy = gsy + guy * v.ly;
  gsz = gsz + guz * v.lz;
  glx = glx + gux * v.sx;
  gly = gly + guy * v.sy;
  glz = glz + guz * v.sz;
  gjx = gjx - gux;
  gjy = gjy - guy;
  gjz = gjz - guz;
  gsx = gsx + gc * v.lx * v.lx;
  gsy = gsy + gc * v.ly * v.ly;
  gsz = gsz + gc * v.lz * v.lz;
  glx = glx + 2.0f * gc * v.sx * v.lx - 2.0f * gc * v.jx;
  gly = gly + 2.0f * gc * v.sy * v.ly - 2.0f * gc * v.jy;
  glz = glz + 2.0f * gc * v.sz * v.lz - 2.0f * gc * v.jz;
  gjx = gjx - 2.0f * gc * v.lx;
  gjy = gjy - 2.0f * gc * v.ly;
  gjz = gjz - 2.0f * gc * v.lz;
  const float gsw = -gc;
  gi00 = gi00 + glx * v.rx + gex * dx;
  gi01 = gi01 + glx * v.ry + gex * dy;
  gi02 = gi02 + glx * v.rz + gex * dz;
  gi10 = gi10 + gly * v.rx + gey * dx;
  gi11 = gi11 + gly * v.ry + gey * dy;
  gi12 = gi12 + gly * v.rz + gey * dz;
  gi20 = gi20 + glz * v.rx + gez * dx;
  gi21 = gi21 + glz * v.ry + gez * dy;
  gi22 = gi22 + glz * v.rz + gez * dz;
  const float grx = v.i00 * glx + v.i10 * gly + v.i20 * glz;
  const float gry = v.i01 * glx + v.i11 * gly + v.i21 * glz;
  const float grz = v.i02 * glx + v.i12 * gly + v.i22 * glz;
  gdx = gdx + (v.i00 * gex + v.i10 * gey + v.i20 * gez);
  gdy = gdy + (v.i01 * gex + v.i11 * gey + v.i21 * gez);
  gdz = gdz + (v.i02 * gex + v.i12 * gey + v.i22 * gez);
  gox = gox + grx;
  goy = goy + gry;
  goz = goz + grz;
  const float gs[SF] = {-grx, -gry, -grz, gi00, gi01, gi02, gi10,
                        gi11, gi12, gi20, gi21, gi22, gsx,  gsy,
                        gsz,  gjx,  gjy,  gjz,  gsw};
  const float gm[MF] = {gmr,   gmg,   gmb,   g_dff, g_spc,
                        g_pow, g_rfl, g_trn, g_rfr, g_ext};
  const float gst[SROWS] = {gox, goy, goz, gdx, gdy, gdz, gtr, gtg, gtb};
#pragma unroll
  for (int f = 0; f < SF; ++f) out.s[f] = gs[f];
#pragma unroll
  for (int f = 0; f < MF; ++f) out.m[f] = gm[f];
#pragma unroll
  for (int f = 0; f < SROWS; ++f) out.st[f] = gst[f];
}

// ray i's (ii = i, or the last ray for a lane past it, `in` false) K
// segments in reverse: its row gradients, and its lights' and ambient's
// added into its warp's accumulators lacc
__device__ __forceinline__ void bwd_ray(const Tabs& t, bool ug, bool uf,
                        const int* __restrict__ paths,
                        const float* __restrict__ state,
                        const int* __restrict__ ids,
                        const float* __restrict__ g_cols,
                        float* __restrict__ g_s, float* __restrict__ g_m,
                        float* lacc, int ii, bool in, int n, int k_segs) {
  const float gar = g_cols[(size_t)ii * 3 + 0];
  const float gag = g_cols[(size_t)ii * 3 + 1];
  const float gab = g_cols[(size_t)ii * 3 + 2];
  const size_t kn = (size_t)k_segs * n;
  float gnext[SROWS];
#pragma unroll
  for (int f = 0; f < SROWS; ++f) gnext[f] = 0.0f;
  for (int k = k_segs - 1; k >= 0; --k) {
    const size_t at = (size_t)k * n + ii;
    const int rec = paths[at];
    const bool live = in && ((((rec >> 15) & 1) != 0) || ((rec >> 13) & 3));
    if (!__any_sync(FULL, live)) {
      if (in) {
#pragma unroll
        for (int f = 0; f < SF; ++f) g_s[(size_t)f * kn + at] = 0.0f;
#pragma unroll
        for (int f = 0; f < MF; ++f) g_m[(size_t)f * kn + at] = 0.0f;
      }
      continue;
    }
    Seg v;
    const float* st = state + (size_t)k * SROWS * n + ii;
    v.ox = st[0 * (size_t)n];
    v.oy = st[1 * (size_t)n];
    v.oz = st[2 * (size_t)n];
    v.dx = st[3 * (size_t)n];
    v.dy = st[4 * (size_t)n];
    v.dz = st[5 * (size_t)n];
    const float tr = st[6 * (size_t)n];
    const float tg = st[7 * (size_t)n];
    const float tb = st[8 * (size_t)n];
    load_rows(v, t, ids[at], ids[kn + at]);
    const bool last = k + 1 == k_segs;
    segment(v, rec, ug, uf, last);
    float col_r, col_g, col_b;
    color(v, t, rec, col_r, col_g, col_b);
    Grads o;
    adjoint(v, t, rec, tr, tg, tb, col_r, col_g, col_b, gar, gag, gab, gnext,
            last, live, lacc, o);
    if (in) {
#pragma unroll
      for (int f = 0; f < SF; ++f)
        g_s[(size_t)f * kn + at] = live ? o.s[f] : 0.0f;
#pragma unroll
      for (int f = 0; f < MF; ++f)
        g_m[(size_t)f * kn + at] = live ? o.m[f] : 0.0f;
    }
#pragma unroll
    for (int f = 0; f < SROWS; ++f) gnext[f] = live ? o.st[f] : gnext[f];
  }
}

__global__ void __launch_bounds__(SEG_THREADS)
    replay_fwd_kernel(Tabs t, const float* __restrict__ use_gamma,
                      const float* __restrict__ use_fresnel,
                      const float* __restrict__ org, int org_stride,
                      const float* __restrict__ dirs,
                      const int* __restrict__ paths, float* __restrict__ cols,
                      float* __restrict__ state, int* __restrict__ ids, int n,
                      int k_segs) {
  const int i = blockIdx.x * SEG_THREADS + threadIdx.x;
  if (i >= n) return;
  fwd_ray(t, __ldg(use_gamma) > 0.0f, __ldg(use_fresnel) > 0.0f, org,
          org_stride, dirs, paths, cols, state, ids, i, n, k_segs);
}

// lacc: SEG_WARPS x nla floats of dynamic shared memory
__global__ void __launch_bounds__(SEG_THREADS)
    replay_bwd_kernel(Tabs t, const float* __restrict__ use_gamma,
                      const float* __restrict__ use_fresnel,
                      const int* __restrict__ paths,
                      const float* __restrict__ state,
                      const int* __restrict__ ids,
                      const float* __restrict__ g_cols,
                      float* __restrict__ g_s, float* __restrict__ g_m,
                      float* __restrict__ lpart, int n, int k_segs) {
  extern __shared__ float lacc[];
  const int nla = LROW * t.nl + 3;
  for (int j = threadIdx.x; j < SEG_WARPS * nla; j += blockDim.x)
    lacc[j] = 0.0f;
  __syncthreads();
  const int i = blockIdx.x * SEG_THREADS + threadIdx.x;
  bwd_ray(t, __ldg(use_gamma) > 0.0f, __ldg(use_fresnel) > 0.0f, paths, state,
          ids, g_cols, g_s, g_m, lacc + (threadIdx.x / WARP) * nla,
          i < n ? i : n - 1, i < n, n, k_segs);
  __syncthreads();
  for (int f = threadIdx.x; f < nla; f += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < SEG_WARPS; ++u) s += lacc[u * nla + f];
    lpart[(size_t)blockIdx.x * nla + f] = s;
  }
}

// the blocks' light partials added in block order, LGROUP blocks a group
// (a thread a group and float), then the groups in group order
__global__ void light_group_kernel(const float* __restrict__ lpart,
                                   float* __restrict__ lgroup, int blocks,
                                   int nla) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (blocks + LGROUP - 1) / LGROUP * nla) return;
  const int g = k / nla, f = k % nla;
  lgroup[k] = ordered_sum(lpart + (size_t)g * LGROUP * nla + f, nla,
                          min(LGROUP, blocks - g * LGROUP));
}

__global__ void light_sum_kernel(const float* __restrict__ lgroup,
                                 float* __restrict__ out, int groups,
                                 int nla) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nla) return;
  out[f] = ordered_sum(lgroup + f, nla, groups);
}

// the light accumulators' bytes past the default 48 KB (over 306 lights)
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The fused forward. Tables: stab (19, ns), mtab (10, nm), ltab (nl, 10),
// amb (3,) f32; s_kind (ns,), s_mat (ns, 2), m_props (nm,) i32; use_gamma,
// use_fresnel () f32. Rays: org (n, 3) rows org_stride floats apart (0: one
// origin), dirs (n, 3), paths (k, n) i32. Out: cols (n, 3), state (k, 9,
// n) f32, ids (2, k, n) i32. Returns the CUDA error of the launch.
extern "C" int replay_forward_launch(
    const float* stab, const float* mtab, const float* ltab, const float* amb,
    const int* s_kind, const int* s_mat, const int* m_props,
    const float* use_gamma, const float* use_fresnel, const float* org,
    const float* dirs, const int* paths, float* cols, float* state, int* ids,
    int n, int k, int ns, int nm, int nl, int org_stride, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (ns <= 0 || nm <= 0 || nl < 0) return (int)cudaErrorInvalidValue;
  const Tabs t{stab, mtab, ltab, amb, s_kind, s_mat, m_props, ns, nm, nl};
  replay_fwd_kernel<<<(n + SEG_THREADS - 1) / SEG_THREADS, SEG_THREADS, 0,
                      (cudaStream_t)stream>>>(t, use_gamma, use_fresnel, org,
                                              org_stride, dirs, paths, cols,
                                              state, ids, n, k);
  return (int)cudaGetLastError();
}

// The light sums: g_la (nla,) from the partials lpart (blocks, nla) of the
// backward blocks, added in block order, LGROUP blocks a group, through
// lgroup (ceil(blocks / LGROUP), nla), then the groups in group order
// (light_group_kernel, light_sum_kernel); the fused replay's backward and
// the differentiable route's (csrc/diff.cu) end with them. Returns the
// CUDA error of the launches.
extern "C" int replay_light_sums_launch(const float* lpart, float* lgroup,
                                        float* g_la, int blocks, int nla,
                                        void* stream) {
  if (blocks < 0 || nla <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int groups = (blocks + LGROUP - 1) / LGROUP;
  if (groups > 0) {
    light_group_kernel<<<(groups * nla + 127) / 128, 128, 0, st>>>(
        lpart, lgroup, blocks, nla);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  light_sum_kernel<<<(nla + 127) / 128, 128, 0, st>>>(lgroup, g_la, groups,
                                                      nla);
  return (int)cudaGetLastError();
}

// The fused backward: g_s (19, k n) and g_m (10, k n) the row gradients of
// each segment's rays (summed per row by row_gather_backward_launch), and
// g_la (10 nl + 3,) the lights' (ltab's layout) and the ambient's
// gradients, through lpart (ceil(n / 128), 10 nl + 3) and lgroup
// (ceil(ceil(n / 128) / 32), 10 nl + 3), from g_cols (n, 3) and the
// forward's state and ids. Returns the CUDA error of the launches.
extern "C" int replay_backward_launch(
    const float* stab, const float* mtab, const float* ltab, const float* amb,
    const int* s_kind, const int* s_mat, const int* m_props,
    const float* use_gamma, const float* use_fresnel, const int* paths,
    const float* state, const int* ids, const float* g_cols, float* g_s,
    float* g_m, float* lpart, float* lgroup, float* g_la, int n, int k,
    int ns, int nm, int nl, void* stream) {
  if (ns <= 0 || nm <= 0 || nl < 0 || n < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nla = LROW * nl + 3;
  const int blocks = (n + SEG_THREADS - 1) / SEG_THREADS;
  if (blocks > 0 && k > 0) {
    const Tabs t{stab, mtab, ltab, amb, s_kind, s_mat, m_props, ns, nm, nl};
    const size_t bytes = sizeof(float) * SEG_WARPS * nla;
    cudaError_t err = allow_smem((const void*)replay_bwd_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    replay_bwd_kernel<<<blocks, SEG_THREADS, bytes, st>>>(
        t, use_gamma, use_fresnel, paths, state, ids, g_cols, g_s, g_m, lpart,
        n, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return replay_light_sums_launch(lpart, lgroup, g_la, k > 0 ? blocks : 0,
                                  nla, stream);
}
