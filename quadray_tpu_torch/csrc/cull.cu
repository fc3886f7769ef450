// The culling tables of the Whitted kernel's bounding-sphere culling, for
// NVIDIA Hopper (sm_90a): bsph_t, shad_msk and cont_msk, one launch each.
//
// Their plain versions are ops/cuda_kernel.py _bsph_t_plain,
// _shad_msk_plain and _cont_msk_plain (the JAX package's jnp tables,
// pallas_kernel.py:346-435, in the same f32 operations and order), which
// take about a hundred small PyTorch launches for a scene whose surfaces
// or lights move every frame. Here each table is one launch: a thread per
// output word (32 surfaces of one row), each surface pair through the
// plain version's operations in its order, so the words are its bits
// (ops/_build.py NVCC_FLAGS: no contraction into FMA, IEEE division and
// sqrt). The rows are the permuted rows of KernelStruct.perm, as the
// Whitted kernel reads them; bit b of word w of a row is surface 32w + b.
//
// What bounds it on the H100: neither, at the scenes' sizes (at most
// 1024 surfaces): a launch is a few microseconds of a few hundred
// thousand surface pairs.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int LANES = 128;     // bsph_t's row padding (the kernel's lanes)
constexpr float NORM_MIN = 1e-30f;
constexpr float SLACK = 1e-3f;

struct Sphere {
  float x, y, z, r;   // centre, radius (+inf where unbounded)
  bool bounded;
};

// _spheres: the bounding sphere of permuted row i
__device__ __forceinline__ Sphere sphere(const long long* perm,
                                         const float* bsph, const int* bnd,
                                         int i) {
  const int s = (int)perm[i];
  Sphere o;
  o.x = ldf(bsph, 4 * s);
  o.y = ldf(bsph, 4 * s + 1);
  o.z = ldf(bsph, 4 * s + 2);
  o.bounded = ldi(bnd, s) > 0;
  o.r = o.bounded ? (float)sqrt((double)ldf(bsph, 4 * s + 3))
                  : __int_as_float(0x7f800000);
  return o;
}

__global__ void bsph_kernel(const long long* perm, const float* bsph,
                            const int* bnd, float* out, int ns, int nsl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nsl) return;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (i < ns) {
    const Sphere s = sphere(perm, bsph, bnd, i);
    v[0] = s.x, v[1] = s.y, v[2] = s.z, v[3] = s.r;
  }
  for (int k = 0; k < 4; ++k) out[k * nsl + i] = v[k];
}

// lsort: blocker c may shadow receiver r from light l unless c's sphere
// misses the capsule from l to r's sphere; thread i is word (r, l * nw +
// w) of the row-major (ns, nl * nw) table
__global__ void shad_kernel(const long long* perm, const float* bsph,
                            const int* bnd, const float* lpos, int* out,
                            int ns, int nl, int nw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ns * nl * nw) return;
  const int r = i / (nl * nw), w = i % (nl * nw);
  const int l = w / nw, c0 = (w % nw) * 32;
  const float px = ldf(lpos, 3 * l), py = ldf(lpos, 3 * l + 1),
              pz = ldf(lpos, 3 * l + 2);
  const Sphere rs = sphere(perm, bsph, bnd, r);
  const float ux = rs.x - px, uy = rs.y - py, uz = rs.z - pz;
  const float uu = maxn(ux * ux + uy * uy + uz * uz, NORM_MIN);
  unsigned word = 0u;
  for (int b = 0; b < 32 && c0 + b < ns; ++b) {
    const Sphere cs = sphere(perm, bsph, bnd, c0 + b);
    const float lx = cs.x - px, ly = cs.y - py, lz = cs.z - pz;
    const float tp = clampn((lx * ux + ly * uy + lz * uz) / uu, 0.0f, 1.0f);
    const float qx = lx - tp * ux, qy = ly - tp * uy, qz = lz - tp * uz;
    const float re = rs.r + cs.r + SLACK;
    const bool occ = !(qx * qx + qy * qy + qz * qz > re * re) || !cs.bounded;
    word |= (unsigned)occ << b;
  }
  out[i] = (int)word;
}

// lst_p: the surfaces a ray continuing from row r's side si may hit (a
// plane's reflection stays in its hit side's closed halfspace, a
// transmission crosses it); thread i is word (r, si * nw + w) of the
// row-major (ns, 2 * nw) table
__global__ void cont_kernel(const long long* perm, const float* bsph,
                            const int* bnd, const float* inv,
                            const float* pos, const int* kind,
                            const int* smat, const int* props,
                            const float* use_fresnel, int* out, int ns,
                            int nw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ns * 2 * nw) return;
  const int r = i / (2 * nw), w = i % (2 * nw);
  const int si = w / nw, c0 = (w % nw) * 32;
  const int s = (int)perm[r];
  float nx = ldf(inv, 9 * s + 6), ny = ldf(inv, 9 * s + 7),
        nz = ldf(inv, 9 * s + 8);
  const float nn = maxn(nx * nx + ny * ny + nz * nz, NORM_MIN);
  const float rn = (float)rsqrt((double)nn);
  nx = nx * rn, ny = ny * rn, nz = nz * rn;
  const float ox = ldf(pos, 3 * s), oy = ldf(pos, 3 * s + 1),
              oz = ldf(pos, 3 * s + 2);
  const int pm = ldi(props, ldi(smat, 2 * s + si));
  const bool can_rfl = (pm & PROP_REFLECT) != 0 ||
                       (ldf(use_fresnel, 0) > 0.0f && (pm & PROP_OPAQUE) == 0);
  const bool can_trn = (pm & PROP_OPAQUE) == 0;
  const bool anyc = can_rfl || can_trn;
  const bool plane = ldi(kind, s) == 1;
  unsigned word = 0u;
  for (int b = 0; b < 32 && c0 + b < ns; ++b) {
    const Sphere cs = sphere(perm, bsph, bnd, c0 + b);
    const float dx = cs.x - ox, dy = cs.y - oy, dz = cs.z - oz;
    const float sgn = dx * nx + dy * ny + dz * nz;
    const float distb =
        (float)sqrt((double)maxn(dx * dx + dy * dy + dz * dz, 0.0f));
    const float slack = cs.r + SLACK + SLACK * distb;
    const bool h_pos = !(sgn < -slack), h_neg = !(sgn > slack);
    const bool same = si == 0 ? h_pos : h_neg, opp = si == 0 ? h_neg : h_pos;
    bool mk = (can_rfl && same) || (can_trn && opp);
    mk = (plane ? mk : anyc) || !cs.bounded;
    word |= (unsigned)(mk && anyc) << b;
  }
  out[i] = (int)word;
}

constexpr int THREADS = 128;

int status() { return (int)cudaGetLastError(); }

}  // namespace

// table: 0 bsph_t (out (4, 1, nsl) f32), 1 shad_msk (out (ns, nl * nw)
// i32, nl > 0), 2 cont_msk (out (ns, 2 * nw) i32); nw = ceil(ns / 32)
extern "C" int cull_launch(int table, const long long* perm,
                           const float* bsph, const int* bnd,
                           const float* lpos, const float* inv,
                           const float* pos, const int* kind,
                           const int* smat, const int* props,
                           const float* use_fresnel, void* out, int ns,
                           int nl, void* stream) {
  if (ns <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int nw = (ns + 31) / 32;
  if (table == 0) {
    const int nsl = (ns + LANES - 1) / LANES * LANES;
    bsph_kernel<<<(nsl + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        perm, bsph, bnd, (float*)out, ns, nsl);
  } else if (table == 1) {
    if (nl <= 0) return (int)cudaErrorInvalidValue;
    const int n = ns * nl * nw;
    shad_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        perm, bsph, bnd, lpos, (int*)out, ns, nl, nw);
  } else if (table == 2) {
    const int n = ns * 2 * nw;
    cont_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        perm, bsph, bnd, inv, pos, kind, smat, props, use_fresnel,
        (int*)out, ns, nw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return status();
}
