// Kernel-op conformance tier for NVIDIA Hopper (sm_90a): one small
// elementwise kernel per case of tests/test_conformance.py.
//
// Replaces the TPU test kernel tests/test_conformance.py _pallas_elementwise
// (one pallas_call per case), which asks whether the kernel compiler lies:
// each building block of the megakernel runs as its own kernel and as the
// plain framework op on the same inputs. Here the compiler is nvcc with
// the megakernel's own flags (ops/_build.py NVCC_FLAGS: --fmad=false,
// IEEE division and sqrt, no fast math), and the blocks that the
// megakernel shares are its very functions from common.cuh (root, sdiv,
// maxn, clampn, sgnf), as the JAX test runs the Pallas kernel's own
// _root/_sdiv. The plain versions and the wrapper are
// quadray_tpu_torch/ops/conformance.py; the case order below is its CASES.
//
// What bounds it on the H100: bytes (4 to 12 read and 4 written per
// element, a few FP32 operations each); at the tier's (8, 128) tiles a
// launch is all overhead. Each thread computes four consecutive elements
// with one 16-byte load per input and one 16-byte store (float4; int4 for
// the gather's indices), neighbouring threads on neighbouring 16 bytes,
// in blocks of 256 threads: the 16-byte accesses of PyTorch's vectorized
// elementwise loop, and a quarter of the memory instructions of one
// element a thread. The wrapper asks for that path (vec) when every
// pointer is 16-byte aligned; the last group of a length that is not a
// multiple of 4, and every group when a pointer is not aligned, goes
// element by element through the same per-element function, so the bits
// do not depend on the path. The three building blocks that are mostly
// arithmetic (roots, Fresnel, root/sdiv) keep one element a thread
// (elems).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// case ids: the index of each case in ops/conformance.py CASES
enum Op {
  ADD, MUL, DIV, SQRT, RSQRT, EXP, LOG, FMA, MIN_MAX, ABS_NEG,
  ROOTS, FRESNEL, SPEC_POW, GATHER, ROOT_SDIV, N_OPS
};
constexpr int LANES = 128;   // the gather's row width (one TPU lane row)

// the stable b-mixed quadric roots with near-zero determinant sorting
// (test_conformance.py:90-113, tracer.cpp:4518-4623): root a + 1e-3 root b
__device__ __forceinline__ float quadric_roots(float a, float b, float c) {
  const float disc = b * b - a * c;
  const bool quad_ok = disc >= 0.0f;
  const float sq = __fsqrt_rn(maxn(disc, 0.0f));
  const float q = -(b + sgnf(b) * sq);
  const bool b_pos = b > 0.0f;
  bool ok1, ok2;
  const float t1 = root(b_pos ? q : c, b_pos ? a : q, ok1);
  const float t2 = root(b_pos ? c : q, b_pos ? q : a, ok2);
  const bool dmask = quad_ok && disc < D_EPS;
  const float sgn_a = sgnf(a);
  const float u = (t1 - t2) * sgn_a;
  float tdff = (u >= 0.0f ? -0.5f * u - fabsf(T_EPS * t1) : 0.0f) * sgn_a;
  if (!(dmask && ok1 && ok2)) tdff = 0.0f;
  return (quad_ok && ok1 ? t1 + tdff : BIG) +
         1e-3f * (quad_ok && ok2 ? t2 - tdff : BIG);
}

// exact dielectric Fresnel with TIR (test_conformance.py:131-144, the
// arithmetic of common.cuh fresnel() for a unit direction)
__device__ __forceinline__ float fresnel_f(float eta, float dot) {
  const float ed = eta * dot;
  const float k = 1.0f - eta * eta + ed * ed;
  const float sq = __fsqrt_rn(maxn(k, 0.0f));
  const float rs = sdiv(ed + sq, ed - sq, 1.0f);
  const float rp = sdiv(dot + eta * sq, dot - eta * sq, 1.0f);
  const float F = clampn(0.5f * (rs * rs + rp * rp), 0.0f, 1.0f);
  return k < 0.0f ? 1.0f : F;
}

// case OP on one element of each input (the gather: element i, whose
// row starts at x[i - i % LANES], and its index g)
template <int OP>
__device__ __forceinline__ float op(float x, float y, float z, int g, int i,
                                    const float* __restrict__ xs) {
  switch (OP) {
    case ADD: return x + y;
    case MUL: return x * y;
    case DIV: return x / y;
    case SQRT: return __fsqrt_rn(x);
    case RSQRT: return __frsqrt_rn(x);
    case EXP: return expf(x);
    case LOG: return logf(x);
    case FMA: return x * y + y;   // two roundings (--fmad=false)
    case MIN_MAX: return fmaxf(x, y) - fminf(x, y);
    case ABS_NEG: return fabsf(-x);
    case ROOTS: return quadric_roots(x, y, z);
    case FRESNEL: return fresnel_f(x, y);
    case SPEC_POW: return expf(y * logf(x));   // the specular power
    case GATHER: return xs[i - i % LANES + g];  // within its row
    case ROOT_SDIV: {
      // the megakernel's own root and sdiv, composed as
      // test_conformance.py:195-197
      bool ok;
      const float rt = root(x, y, ok);
      return rt + 1e3f * (ok ? 1.0f : 0.0f) + 1e-3f * sdiv(x, y, BIG);
    }
    default: return 0.0f;
  }
}

// the inputs a case reads elementwise: x (not the gather's table), y, z
__host__ __device__ constexpr bool reads_x(int o) { return o != GATHER; }
__host__ __device__ constexpr bool reads_y(int o) {
  return o == ADD || o == MUL || o == DIV || o == FMA || o == MIN_MAX ||
         o == ROOTS || o == FRESNEL || o == SPEC_POW || o == ROOT_SDIV;
}
__host__ __device__ constexpr bool reads_z(int o) { return o == ROOTS; }

// threads a block: on an H100, 256 ran the 16-byte cases 1-2% faster than
// 128, and the one-element cases as before, where 128 lost 6-29%
constexpr int BLOCK = 256;
constexpr int VEC = 4;       // elements in one 16-byte group
// consecutive elements a thread: a 16-byte group, but one element for the
// cases whose arithmetic outweighs their bytes (the roots, Fresnel and
// root/sdiv blocks ran 9-19% slower at four elements a thread on an H100:
// a quarter of the threads to hide the latency of their division and
// square-root sequences)
__host__ __device__ constexpr int elems(int o) {
  return o == ROOTS || o == FRESNEL || o == ROOT_SDIV ? 1 : VEC;
}

// elements E t .. E t + E - 1 of thread t, E = elems(OP); vec: every
// pointer is 16-byte aligned
template <int OP>
__global__ void __launch_bounds__(BLOCK)
conf_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ z, const int* __restrict__ gi,
            float* __restrict__ out, int n, int vec) {
  constexpr int E = elems(OP);
  const int i = E * (int)(blockIdx.x * BLOCK + threadIdx.x);
  if (i >= n) return;
  if (E == 1) {   // the cases that read x, y (and z) elementwise
    out[i] = op<OP>(x[i], y[i], reads_z(OP) ? z[i] : 0.0f, 0, i, x);
    return;
  }
  if (vec && i + VEC <= n) {
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 a = reads_x(OP) ? *(const float4*)(x + i) : zero4;
    const float4 b = reads_y(OP) ? *(const float4*)(y + i) : zero4;
    const float4 c = reads_z(OP) ? *(const float4*)(z + i) : zero4;
    const int4 g = OP == GATHER ? *(const int4*)(gi + i)
                                : make_int4(0, 0, 0, 0);
    float4 r;
    r.x = op<OP>(a.x, b.x, c.x, g.x, i, x);
    r.y = op<OP>(a.y, b.y, c.y, g.y, i + 1, x);
    r.z = op<OP>(a.z, b.z, c.z, g.z, i + 2, x);
    r.w = op<OP>(a.w, b.w, c.w, g.w, i + 3, x);
    *(float4*)(out + i) = r;
    return;
  }
  const int end = i + E < n ? i + E : n;
  for (int k = i; k < end; ++k)
    out[k] = op<OP>(reads_x(OP) ? x[k] : 0.0f, reads_y(OP) ? y[k] : 0.0f,
                    reads_z(OP) ? z[k] : 0.0f, OP == GATHER ? gi[k] : 0, k,
                    x);
}

template <int OP>
int launch(const float* x, const float* y, const float* z, const int* gi,
           float* out, int n, int vec, cudaStream_t s) {
  const int threads = (n + elems(OP) - 1) / elems(OP);
  conf_kernel<OP><<<(unsigned)((threads + BLOCK - 1) / BLOCK), BLOCK, 0,
                    s>>>(x, y, z, gi, out, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes): case `op` on n f32 elements x (y, z
// as the case reads them; idx: the gather's i32 indices, each in
// 0..127, into the 128-element row of its element), out n f32; vec: take
// the 16-byte path (every pointer the case reads or writes 16-byte
// aligned; ops/conformance.py vector_split), after the stream, so that a
// caller of the entry point from before that path passes the arguments
// it reads. Launches on `stream`, allocates nothing, does not
// synchronise; returns the cudaError_t of the launch
// (cudaErrorMisalignedAddress for vec with a pointer that is not
// aligned).
extern "C" int conformance_launch(int op, const float* x, const float* y,
                                  const float* z, const int* idx,
                                  float* out, int n, void* stream, int vec) {
  if (n <= 0) return 0;
  if (vec && (((size_t)x | (size_t)y | (size_t)z | (size_t)idx |
               (size_t)out) & 15u))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case ADD: return launch<ADD>(x, y, z, idx, out, n, vec, s);
    case MUL: return launch<MUL>(x, y, z, idx, out, n, vec, s);
    case DIV: return launch<DIV>(x, y, z, idx, out, n, vec, s);
    case SQRT: return launch<SQRT>(x, y, z, idx, out, n, vec, s);
    case RSQRT: return launch<RSQRT>(x, y, z, idx, out, n, vec, s);
    case EXP: return launch<EXP>(x, y, z, idx, out, n, vec, s);
    case LOG: return launch<LOG>(x, y, z, idx, out, n, vec, s);
    case FMA: return launch<FMA>(x, y, z, idx, out, n, vec, s);
    case MIN_MAX: return launch<MIN_MAX>(x, y, z, idx, out, n, vec, s);
    case ABS_NEG: return launch<ABS_NEG>(x, y, z, idx, out, n, vec, s);
    case ROOTS: return launch<ROOTS>(x, y, z, idx, out, n, vec, s);
    case FRESNEL: return launch<FRESNEL>(x, y, z, idx, out, n, vec, s);
    case SPEC_POW: return launch<SPEC_POW>(x, y, z, idx, out, n, vec, s);
    case GATHER: return launch<GATHER>(x, y, z, idx, out, n, vec, s);
    case ROOT_SDIV: return launch<ROOT_SDIV>(x, y, z, idx, out, n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// number of cases, for the wrapper's check of its case list
extern "C" int conformance_cases() { return N_OPS; }
