// Replay's row gathers and their backward, for NVIDIA Hopper (sm_90a).
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
  float s = 0.0f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b)
    s += part[((size_t)b * f_rows + f) * nt + r];
  out[(size_t)f * nt + r] = s;
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
