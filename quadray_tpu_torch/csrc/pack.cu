// The scene pack of the Whitted kernels for NVIDIA Hopper (sm_90a): the
// ten tables of ops/cuda_kernel.py PACK_PARTS, any subset of them in one
// launch (pack_launch). The counterpart of the JAX package's pack_scene
// under _pack_jit (quadray_tpu/ops/pallas_kernel.py:300-435, :2143): one
// executable there, one launch here, where the port's PyTorch parts took
// 72 small ops and three more launches for the culling tables.
//
// Each element is its plain version's bits (ops/cuda_kernel.py
// _pack_sp_f ... _pack_tex_pk, _bsph_t_plain, _shad_msk_plain,
// _cont_msk_plain; ops/_build.py NVCC_FLAGS: no contraction into FMA, IEEE
// division and sqrt): the seven copies move values and round texels half
// to even, and the culling words are the plain version's f32 operations in
// its order. The rows are the permuted rows of KernelStruct.perm, as the
// Whitted kernel reads them; bit b of word w of a culling row is surface
// 32w + b.
//
// Grid: each part owns a contiguous range of blocks (PackArgs.start, from
// the shapes, on the host): a thread an element for sp_f and sp_i (a
// permuted row and column), cl_f (a row, clip entry and column), mat_f,
// lg_f, misc and tex_pk (a texel); a thread a column for bsph_t; a thread
// an output word of 32 surfaces for shad_msk and cont_msk. A culling
// block first stages the permuted rows' bounding spheres (centre, radius
// already square-rooted, bounded flag) in shared memory, TILE rows at a
// time, so each sphere's double sqrt runs once a block, not once a pair.
//
// What bounds it on the H100: neither bytes nor operations. A pack is tens
// of KB (demo02 at a J3 frame: about 0.3 MB, most of it the texture atlas)
// and the culling words a few hundred thousand sphere tests; a launch is
// microseconds of latency. What the design saves is launches and the
// host's work around them.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int NPARTS = 10;
// the parts, in PackedScene order
constexpr int SP_F = 0, SP_I = 1, CL_F = 2, MAT_F = 3, LG_F = 4, MISC = 5,
              TEX_PK = 6, BSPH_T = 7, SHAD_MSK = 8, CONT_MSK = 9;
constexpr int PF = 44, SI = 8, CF = 22, MF = 14, LF = 10;
constexpr float NORM_MIN = 1e-30f;
constexpr float SLACK = 1e-3f;
// rows of staged spheres a culling block holds at a time (a multiple of
// 32, so one output word's surfaces lie in one tile)
constexpr int TILE = 1024;
// a staged row k sits at k + k / 32, so the rows 32 apart that one warp's
// words read lie in distinct banks
constexpr int SKEWED = TILE + TILE / 32;

}  // namespace

// The launch's arguments, passed by value (ops/cuda_kernel.py _PackArgs
// mirrors it field for field). A pointer is null where no part of the
// launch reads it.
struct PackArgs {
  const long long* perm;   // (ns,) permuted row -> surface
  const int* blk;          // (ns,) blocker side bits, per permuted row
  const int* ncl;          // (ns,) clip entries, per permuted row
  const float* s_pos;
  const float* s_inv;
  const float* s_sci;
  const float* s_scjh;
  const float* s_sciw;
  const float* s_cmin;
  const float* s_cmax;
  const float* s_fwd;
  const float* s_bsph;
  const float* s_emis;
  const int* s_kind;
  const int* s_mat;
  const int* s_sing;
  const int* s_bnd;
  const int* c_ref;
  const int* c_op;
  const float* c_side;
  const float* m_col;
  const float* m_dff;
  const float* m_spc;
  const float* m_pow;
  const float* m_rfl;
  const float* m_trn;
  const float* m_rfr;
  const float* m_ext;
  const float* m_tex_scl;
  const float* m_tex_off;
  const int* m_props;
  const float* l_pos;
  const float* l_col;
  const float* l_cnt;
  const float* l_lnr;
  const float* l_qdr;
  const float* l_on;
  const float* amb_col;
  const float* use_gamma;
  const float* use_fresnel;
  const float* tex_data;
  void* out[NPARTS];        // each part's table (null where not written)
  int start[NPARTS + 1];    // part p's blocks: [start[p], start[p + 1])
  int count[NPARTS];        // part p's threads
  int ns, nc, nm, nlr;      // surface rows, clip width, materials, light rows
  int nl, ntex, nsl, nw;    // active lights, texels, bsph_t width, words
};

namespace {

// torch.clamp(x, -BIG, BIG) by compare and select: a NaN fails both
// compares and is kept, as -0.0 is (fminf/fmaxf would drop the NaN)
__device__ __forceinline__ float clamp_big(float x) {
  return x < -BIG ? -BIG : (x > BIG ? BIG : x);
}

// _pack_sp_f's element (r, c) of the (ns, PF) table
__device__ __forceinline__ float sp_f_at(const PackArgs& a, int i) {
  const int r = i / PF, c = i % PF;
  const int s = (int)__ldg(a.perm + r);
  if (c < 3) return ldf(a.s_pos, 3 * s + c);
  if (c < 12) return ldf(a.s_inv, 9 * s + c - 3);
  if (c < 15) return ldf(a.s_sci, 3 * s + c - 12);
  if (c < 18) return ldf(a.s_scjh, 3 * s + c - 15);
  if (c == 18) return ldf(a.s_sciw, s);
  if (c < 22) return clamp_big(ldf(a.s_cmin, 3 * s + c - 19));
  if (c < 25) return clamp_big(ldf(a.s_cmax, 3 * s + c - 22));
  if (c < 34) return ldf(a.s_fwd, 9 * s + c - 25);
  if (c < 38) return ldf(a.s_bsph, 4 * s + c - 34);
  return ldf(a.s_emis, 6 * s + c - 38);
}

// _pack_sp_i's element (r, c): kind, outer and inner material, blocker
// bits, singularity, clip entries, original id, bounded
__device__ __forceinline__ int sp_i_at(const PackArgs& a, int i) {
  const int r = i / SI, c = i % SI;
  const int s = (int)__ldg(a.perm + r);
  switch (c) {
    case 0: return ldi(a.s_kind, s);
    case 1: return ldi(a.s_mat, 2 * s);
    case 2: return ldi(a.s_mat, 2 * s + 1);
    case 3: return ldi(a.blk, r);
    case 4: return ldi(a.s_sing, s);
    case 5: return ldi(a.ncl, r);
    case 6: return s;
    default: return ldi(a.s_bnd, s);
  }
}

// _pack_cl_f's element (r, j, c): clip entry j of row r, its clipper's
// surface (an unused entry's c_ref of -1 reads surface 0, as the plain
// version's clamp at 0 does)
__device__ __forceinline__ float cl_f_at(const PackArgs& a, int i) {
  const int r = i / (a.nc * CF), j = i % (a.nc * CF) / CF, c = i % CF;
  const int e = (int)__ldg(a.perm + r) * a.nc + j;
  const int ref = max(ldi(a.c_ref, e), 0);
  if (c < 3) return ldf(a.s_pos, 3 * ref + c);
  if (c < 12) return ldf(a.s_inv, 9 * ref + c - 3);
  if (c < 15) return ldf(a.s_sci, 3 * ref + c - 12);
  if (c < 18) return ldf(a.s_scjh, 3 * ref + c - 15);
  if (c == 18) return ldf(a.s_sciw, ref);
  if (c == 19) return (float)ldi(a.s_kind, ref);
  if (c == 20) return ldf(a.c_side, e);
  return (float)ldi(a.c_op, e);
}

// _pack_mat_f's element (m, c)
__device__ __forceinline__ float mat_f_at(const PackArgs& a, int i) {
  const int m = i / MF, c = i % MF;
  if (c < 3) return ldf(a.m_col, 3 * m + c);
  switch (c) {
    case 3: return ldf(a.m_dff, m);
    case 4: return ldf(a.m_spc, m);
    case 5: return ldf(a.m_pow, m);
    case 6: return ldf(a.m_rfl, m);
    case 7: return ldf(a.m_trn, m);
    case 8: return ldf(a.m_rfr, m);
    case 9: return ldf(a.m_ext, m);
    case 10: case 11: return ldf(a.m_tex_scl, 2 * m + c - 10);
    default: return ldf(a.m_tex_off, 2 * m + c - 12);
  }
}

// _pack_lg_f's element (l, c)
__device__ __forceinline__ float lg_f_at(const PackArgs& a, int i) {
  const int l = i / LF, c = i % LF;
  if (c < 3) return ldf(a.l_pos, 3 * l + c);
  if (c < 6) return ldf(a.l_col, 3 * l + c - 3);
  switch (c) {
    case 6: return ldf(a.l_cnt, l);
    case 7: return ldf(a.l_lnr, l);
    case 8: return ldf(a.l_qdr, l);
    default: return ldf(a.l_on, l);
  }
}

// _pack_misc's element i: ambient rgb, use_gamma, use_fresnel, zeros
__device__ __forceinline__ float misc_at(const PackArgs& a, int i) {
  if (i < 3) return ldf(a.amb_col, i);
  if (i == 3) return ldf(a.use_gamma, 0);
  if (i == 4) return ldf(a.use_fresnel, 0);
  return 0.0f;
}

// _pack_tex_pk's texel i: u8 rgb in one i32 (torch.round halves to even,
// .to(int32) truncates), zero past the atlas
__device__ __forceinline__ int tex_pk_at(const PackArgs& a, int i) {
  if (i >= a.ntex) return 0;
  unsigned k[3];
  for (int c = 0; c < 3; ++c)
    k[c] = (unsigned)(int)rintf(ldf(a.tex_data, 3 * i + c) * 255.0f);
  return (int)((k[0] << 16) | (k[1] << 8) | k[2]);
}

// one element of a copied part p (< BSPH_T)
__device__ __forceinline__ void copy_element(const PackArgs& a, int p,
                                             int i) {
  switch (p) {
    case SP_F: ((float*)a.out[p])[i] = sp_f_at(a, i); break;
    case SP_I: ((int*)a.out[p])[i] = sp_i_at(a, i); break;
    case CL_F: ((float*)a.out[p])[i] = cl_f_at(a, i); break;
    case MAT_F: ((float*)a.out[p])[i] = mat_f_at(a, i); break;
    case LG_F: ((float*)a.out[p])[i] = lg_f_at(a, i); break;
    case MISC: ((float*)a.out[p])[i] = misc_at(a, i); break;
    default: ((int*)a.out[p])[i] = tex_pk_at(a, i); break;
  }
}

struct Sphere {
  float x, y, z, r;   // centre, radius (+inf where unbounded)
  bool bounded;
};

// _spheres: the bounding sphere of permuted row i
__device__ __forceinline__ Sphere sphere(const PackArgs& a, int i) {
  const int s = (int)__ldg(a.perm + i);
  Sphere o;
  o.x = ldf(a.s_bsph, 4 * s);
  o.y = ldf(a.s_bsph, 4 * s + 1);
  o.z = ldf(a.s_bsph, 4 * s + 2);
  o.bounded = ldi(a.s_bnd, s) > 0;
  o.r = o.bounded ? (float)sqrt((double)ldf(a.s_bsph, 4 * s + 3))
                  : __int_as_float(0x7f800000);
  return o;
}

// bsph_t's column i of its (4, 1, nsl) table: row i's sphere, zeros past
// ns
__device__ __forceinline__ void bsph_column(const PackArgs& a, int i) {
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (i < a.ns) {
    const Sphere s = sphere(a, i);
    v[0] = s.x, v[1] = s.y, v[2] = s.z, v[3] = s.r;
  }
  float* out = (float*)a.out[BSPH_T];
  for (int k = 0; k < 4; ++k) out[k * a.nsl + i] = v[k];
}

// a culling block's staged spheres: rows t0 .. t0 + TILE - 1, row k of
// the tile at k + k / 32
struct Staged {
  float x[SKEWED], y[SKEWED], z[SKEWED], r[SKEWED];
  int bounded[SKEWED];
};

__device__ __forceinline__ int skew(int k) { return k + (k >> 5); }

__device__ __forceinline__ void stage(const PackArgs& a, Staged& st,
                                      int t0) {
  const int n = min(TILE, a.ns - t0);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const Sphere s = sphere(a, t0 + k);
    const int j = skew(k);
    st.x[j] = s.x, st.y[j] = s.y, st.z[j] = s.z, st.r[j] = s.r;
    st.bounded[j] = s.bounded;
  }
}

// lsort: blocker c may shadow receiver r from light l unless c's sphere
// misses the capsule from l to r's sphere. Word i of the row-major (ns,
// nl * nw) table is (r, l * nw + w); its receiver's and light's terms
struct ShadWord {
  float px, py, pz, ux, uy, uz, uu, rr;
  int c0;
};

__device__ __forceinline__ ShadWord shad_word(const PackArgs& a, int i) {
  const int r = i / (a.nl * a.nw), w = i % (a.nl * a.nw);
  const int l = w / a.nw;
  ShadWord o;
  o.c0 = (w % a.nw) * 32;
  o.px = ldf(a.l_pos, 3 * l), o.py = ldf(a.l_pos, 3 * l + 1),
  o.pz = ldf(a.l_pos, 3 * l + 2);
  const Sphere rs = sphere(a, r);
  o.ux = rs.x - o.px, o.uy = rs.y - o.py, o.uz = rs.z - o.pz;
  o.uu = maxn(o.ux * o.ux + o.uy * o.uy + o.uz * o.uz, NORM_MIN);
  o.rr = rs.r;
  return o;
}

// the word's bits, its blockers read from the tile that starts at row t0
__device__ __forceinline__ unsigned shad_bits(const PackArgs& a,
                                              const Staged& st,
                                              const ShadWord& q, int t0) {
  unsigned word = 0u;
  const int nb = min(32, a.ns - q.c0);
#pragma unroll 8   // the pairs are independent: overlap their latencies
  for (int b = 0; b < nb; ++b) {
    const int j = skew(q.c0 + b - t0);
    const float lx = st.x[j] - q.px, ly = st.y[j] - q.py,
                lz = st.z[j] - q.pz;
    const float tp =
        clampn((lx * q.ux + ly * q.uy + lz * q.uz) / q.uu, 0.0f, 1.0f);
    const float qx = lx - tp * q.ux, qy = ly - tp * q.uy,
                qz = lz - tp * q.uz;
    const float re = q.rr + st.r[j] + SLACK;
    const bool occ =
        !(qx * qx + qy * qy + qz * qz > re * re) || !st.bounded[j];
    word |= (unsigned)occ << b;
  }
  return word;
}

// lst_p: the surfaces a ray continuing from row r's side si may hit (a
// plane's reflection stays in its hit side's closed halfspace, a
// transmission crosses it). Word i of the row-major (ns, 2 * nw) table is
// (r, si * nw + w); its row's terms
struct ContWord {
  float nx, ny, nz, ox, oy, oz;
  bool can_rfl, can_trn, anyc, plane;
  int si, c0;
};

__device__ __forceinline__ ContWord cont_word(const PackArgs& a, int i) {
  const int r = i / (2 * a.nw), w = i % (2 * a.nw);
  ContWord o;
  o.si = w / a.nw, o.c0 = (w % a.nw) * 32;
  const int s = (int)__ldg(a.perm + r);
  const float nx = ldf(a.s_inv, 9 * s + 6), ny = ldf(a.s_inv, 9 * s + 7),
              nz = ldf(a.s_inv, 9 * s + 8);
  const float nn = maxn(nx * nx + ny * ny + nz * nz, NORM_MIN);
  const float rn = (float)rsqrt((double)nn);
  o.nx = nx * rn, o.ny = ny * rn, o.nz = nz * rn;
  o.ox = ldf(a.s_pos, 3 * s), o.oy = ldf(a.s_pos, 3 * s + 1),
  o.oz = ldf(a.s_pos, 3 * s + 2);
  const int pm = ldi(a.m_props, ldi(a.s_mat, 2 * s + o.si));
  o.can_rfl = (pm & PROP_REFLECT) != 0 ||
              (ldf(a.use_fresnel, 0) > 0.0f && (pm & PROP_OPAQUE) == 0);
  o.can_trn = (pm & PROP_OPAQUE) == 0;
  o.anyc = o.can_rfl || o.can_trn;
  o.plane = ldi(a.s_kind, s) == 1;
  return o;
}

__device__ __forceinline__ unsigned cont_bits(const PackArgs& a,
                                              const Staged& st,
                                              const ContWord& q, int t0) {
  unsigned word = 0u;
  const int nb = min(32, a.ns - q.c0);
#pragma unroll 8   // the pairs are independent: overlap their latencies
  for (int b = 0; b < nb; ++b) {
    const int j = skew(q.c0 + b - t0);
    const float dx = st.x[j] - q.ox, dy = st.y[j] - q.oy,
                dz = st.z[j] - q.oz;
    const float sgn = dx * q.nx + dy * q.ny + dz * q.nz;
    // the plain version's sqrt in f64 rounded to f32 is the correctly
    // rounded f32 sqrt (f64 carries more than 2 * 24 + 2 bits), so the
    // f32 sqrt gives its bits without a chain of f64 operations a pair
    const float distb = __fsqrt_rn(maxn(dx * dx + dy * dy + dz * dz, 0.0f));
    const float slack = st.r[j] + SLACK + SLACK * distb;
    const bool h_pos = !(sgn < -slack), h_neg = !(sgn > slack);
    const bool same = q.si == 0 ? h_pos : h_neg,
               opp = q.si == 0 ? h_neg : h_pos;
    bool mk = (q.can_rfl && same) || (q.can_trn && opp);
    mk = (q.plane ? mk : q.anyc) || !st.bounded[j];
    word |= (unsigned)(mk && q.anyc) << b;
  }
  return word;
}

// the word's surfaces c0 .. c0 + 31 lie in the tile that starts at row t0
__device__ __forceinline__ bool in_tile(int c0, int t0) {
  return c0 >= t0 && c0 < t0 + TILE;
}

constexpr int THREADS = 128;

// a culling block (part p, SHAD_MSK or CONT_MSK): thread i's word, the
// block's spheres staged a tile at a time; every thread of the block
// reaches every barrier
__device__ __forceinline__ void cull_block(const PackArgs& a, int p, int i,
                                           Staged& st) {
  int* out = (int*)a.out[p];
  const bool live = i < a.count[p];
  if (p == SHAD_MSK && a.nl == 0) {   // (ns, 1) zeros: no light
    if (live) out[i] = 0;
    return;
  }
  ShadWord sq;
  ContWord cq;
  int c0 = 0;
  if (live && p == SHAD_MSK) {
    sq = shad_word(a, i);
    c0 = sq.c0;
  } else if (live) {
    cq = cont_word(a, i);
    c0 = cq.c0;
  }
  unsigned word = 0u;
  for (int t0 = 0; t0 < a.ns; t0 += TILE) {
    if (t0) __syncthreads();   // the previous tile's readers are done
    stage(a, st, t0);
    __syncthreads();
    if (live && in_tile(c0, t0))
      word = p == SHAD_MSK ? shad_bits(a, st, sq, t0)
                           : cont_bits(a, st, cq, t0);
  }
  if (live) out[i] = (int)word;
}

// thread t of block b: its part (block-uniform), and its element, column
// or word of that part
__device__ __forceinline__ void pack_thread(const PackArgs& a, int b, int t,
                                            Staged& st) {
  int p = 0;
  while (b >= a.start[p + 1]) ++p;
  const int i = (b - a.start[p]) * THREADS + t;
  if (p < BSPH_T) {
    if (i < a.count[p]) copy_element(a, p, i);
  } else if (p == BSPH_T) {
    if (i < a.count[p]) bsph_column(a, i);
  } else {
    cull_block(a, p, i, st);
  }
}

__global__ void __launch_bounds__(THREADS) pack_kernel(const PackArgs a) {
  __shared__ Staged st;
  pack_thread(a, (int)blockIdx.x, (int)threadIdx.x, st);
}

}  // namespace

// One launch of the parts whose blocks args->start lays out (a part with
// no blocks is not written), on ``stream``; no allocation, no sync, so a
// CUDA graph may capture it. Returns the launch's CUDA error (0 if none).
extern "C" int pack_launch(const PackArgs* args, void* stream) {
  const int blocks = args->start[NPARTS];
  if (blocks <= 0) return 0;
  pack_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
