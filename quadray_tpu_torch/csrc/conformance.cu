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
// What bounds it on the H100: bytes (4 or 8 read and 4 written per
// element, a few FP32 operations each); at the tier's (8, 128) tiles a
// launch is all overhead. Each thread computes one element, neighbouring
// threads neighbouring words.

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

template <int OP>
__global__ void __launch_bounds__(256)
conf_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ z, const int* __restrict__ gi,
            float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float r;
  switch (OP) {
    case ADD: r = x[i] + y[i]; break;
    case MUL: r = x[i] * y[i]; break;
    case DIV: r = x[i] / y[i]; break;
    case SQRT: r = __fsqrt_rn(x[i]); break;
    case RSQRT: r = __frsqrt_rn(x[i]); break;
    case EXP: r = expf(x[i]); break;
    case LOG: r = logf(x[i]); break;
    case FMA: r = x[i] * y[i] + y[i]; break;   // two roundings (--fmad=false)
    case MIN_MAX: r = fmaxf(x[i], y[i]) - fminf(x[i], y[i]); break;
    case ABS_NEG: r = fabsf(-x[i]); break;
    case ROOTS: r = quadric_roots(x[i], y[i], z[i]); break;
    case FRESNEL: r = fresnel_f(x[i], y[i]); break;
    case SPEC_POW: r = expf(y[i] * logf(x[i])); break;   // the specular power
    case GATHER: r = x[i - i % LANES + gi[i]]; break;    // within its row
    case ROOT_SDIV: {
      // the megakernel's own root and sdiv, composed as
      // test_conformance.py:195-197
      bool ok;
      const float rt = root(x[i], y[i], ok);
      r = rt + 1e3f * (ok ? 1.0f : 0.0f) + 1e-3f * sdiv(x[i], y[i], BIG);
      break;
    }
    default: r = 0.0f;
  }
  out[i] = r;
}

template <int OP>
int launch(const float* x, const float* y, const float* z, const int* gi,
           float* out, int n, cudaStream_t s) {
  conf_kernel<OP><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(x, y, z, gi,
                                                                 out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes): case `op` on n f32 elements x (y, z
// as the case reads them; idx: the gather's i32 indices, each in
// 0..127, into the 128-element row of its element), out n f32. Launches
// on `stream`, allocates nothing, does not synchronise; returns the
// cudaError_t of the launch.
extern "C" int conformance_launch(int op, const float* x, const float* y,
                                  const float* z, const int* idx,
                                  float* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case ADD: return launch<ADD>(x, y, z, idx, out, n, s);
    case MUL: return launch<MUL>(x, y, z, idx, out, n, s);
    case DIV: return launch<DIV>(x, y, z, idx, out, n, s);
    case SQRT: return launch<SQRT>(x, y, z, idx, out, n, s);
    case RSQRT: return launch<RSQRT>(x, y, z, idx, out, n, s);
    case EXP: return launch<EXP>(x, y, z, idx, out, n, s);
    case LOG: return launch<LOG>(x, y, z, idx, out, n, s);
    case FMA: return launch<FMA>(x, y, z, idx, out, n, s);
    case MIN_MAX: return launch<MIN_MAX>(x, y, z, idx, out, n, s);
    case ABS_NEG: return launch<ABS_NEG>(x, y, z, idx, out, n, s);
    case ROOTS: return launch<ROOTS>(x, y, z, idx, out, n, s);
    case FRESNEL: return launch<FRESNEL>(x, y, z, idx, out, n, s);
    case SPEC_POW: return launch<SPEC_POW>(x, y, z, idx, out, n, s);
    case GATHER: return launch<GATHER>(x, y, z, idx, out, n, s);
    case ROOT_SDIV: return launch<ROOT_SDIV>(x, y, z, idx, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// number of cases, for the wrapper's check of its case list
extern "C" int conformance_cases() { return N_OPS; }
