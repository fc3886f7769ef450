// Device helpers shared by the CUDA kernels of quadray_tpu_torch: the
// Whitted megakernel (whitted.cu) and the kernel-op conformance tier
// (conformance.cu), which runs these very functions against their plain
// versions, as tests/test_conformance.py runs the Pallas kernel's own
// _root/_sdiv. Header only; everything has internal linkage.
//
// f32 rules: build with --fmad=false and without fast math (ops/_build.py
// NVCC_FLAGS); sqrt is __fsqrt_rn and rsqrt __frsqrt_rn.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr float D_EPS = 1e-11f;   // near-zero determinant (object.h:41)
constexpr float T_EPS = 1e-7f;    // root sorting / apex nudge (object.h:42)

// material property bits (scene/compile.py PROP_*)
constexpr int PROP_LIGHT = 1 << 0, PROP_METAL = 1 << 1,
              PROP_OPAQUE = 1 << 2, PROP_REFLECT = 1 << 3,
              PROP_REFRACT = 1 << 4, PROP_DIFFUSE = 1 << 5,
              PROP_SPECULAR = 1 << 6, PROP_TEXTURE = 1 << 7,
              PROP_GAMMA = 1 << 8, PROP_FRESNEL = 1 << 9;

__device__ __forceinline__ float ldf(const float* p, int i) {
  return __ldg(p + i);
}
__device__ __forceinline__ int ldi(const int* p, int i) {
  return __ldg(p + i);
}
// a scene-table value: through the read-only cache, or (SM: the kernel
// copied the table into its block's shared memory) a plain load, which
// the compiler makes a shared-memory load where it sees the table's origin
template <bool SM>
__device__ __forceinline__ float ldt(const float* p, int i) {
  return SM ? p[i] : __ldg(p + i);
}
template <bool SM>
__device__ __forceinline__ int ldt(const int* p, int i) {
  return SM ? p[i] : __ldg(p + i);
}

// NaN-propagating max/clamp (jnp.maximum / jnp.clip semantics)
__device__ __forceinline__ float maxn(float x, float lo) {
  return (x != x || x >= lo) ? x : lo;
}
__device__ __forceinline__ float clampn(float x, float lo, float hi) {
  x = maxn(x, lo);
  return (x != x || x <= hi) ? x : hi;
}
__device__ __forceinline__ float sgnf(float x) {
  return x >= 0.0f ? 1.0f : -1.0f;
}
// _safe_div: |den| < 1e-30 -> fallback
__device__ __forceinline__ float sdiv(float num, float den, float fb) {
  return fabsf(den) < 1e-30f ? fb : num / den;
}
// nan-root rule (tracer.cpp:4585-4600): zero numerator -> root 0; zero
// denominator with a nonzero numerator -> invalid
__device__ __forceinline__ float root(float num, float den, bool& ok) {
  if (num == 0.0f) den = 1.0f;
  ok = den != 0.0f;
  return ok ? num / den : BIG;
}

struct Fresnel {
  float c_rfl, c_trn;     // effective reflect / transmit weights
  float rfx, rfy, rfz;    // refraction direction (the unit ray if none)
};

// Fresnel / refraction (tracer.cpp:3182-3424) for ray direction d at unit
// normal n facing the ray: TR section with TIR, and the RF-section
// reflectivity Fresnel of opaque reflective materials (tracer.cpp:
// 3671-3830: the metal fast conductor formula, plain dielectric otherwise);
// SM: the material row M is in shared memory; schlick: Schlick's F on the
// transparency path (RT_FEAT_SCHLICK, tracer.cpp:3355-3381; ops/trace.py
// fresnel_schlick's f32 operations and order), which every Whitted mode
// takes from TraceConfig.schlick and PT never does (its Fresnel does not
// read the flag in the reference either)
template <bool SM = false>
__device__ __forceinline__ Fresnel fresnel(int props, const float* M,
                                           bool fres_scene, float dx,
                                           float dy, float dz, float nx,
                                           float ny, float nz,
                                           bool schlick = false) {
  const float m_rfl = ldt<SM>(M, 6), m_trn = ldt<SM>(M, 7),
              m_rfr = ldt<SM>(M, 8);
  const float m_ext = ldt<SM>(M, 9);
  const float dl = __frsqrt_rn(maxn(dx * dx + dy * dy + dz * dz, 1e-30f));
  const float rhx = dx * dl, rhy = dy * dl, rhz = dz * dl;
  const float dot = rhx * nx + rhy * ny + rhz * nz;
  const float eta = m_rfr;
  const float ed = eta * dot;
  const float kk = 1.0f - eta * eta + ed * ed;
  const bool refracts = props & PROP_REFRACT;
  const bool tir = kk < 0.0f && refracts;
  const float sq = kk > 0.0f ? __fsqrt_rn(kk) : 0.0f;
  Fresnel f;
  f.rfx = rhx; f.rfy = rhy; f.rfz = rhz;
  if (refracts) {
    f.rfx = eta * rhx - nx * (ed + sq);
    f.rfy = eta * rhy - ny * (ed + sq);
    f.rfz = eta * rhz - nz * (ed + sq);
  }
  const bool fres_prop = fres_scene && (props & PROP_FRESNEL);
  const bool opaque = props & PROP_OPAQUE;
  const bool fres_on = fres_prop && !opaque;
  const float rs = sdiv(ed + sq, ed - sq, 1.0f);
  const float rp = sdiv(dot + eta * sq, dot - eta * sq, 1.0f);
  float F0 = 0.5f * (rs * rs + rp * rp);
  if (schlick) {
    const float x = eta > 1.0f ? 1.0f - sq : 1.0f + dot;
    const float r = sdiv(eta - 1.0f, eta + 1.0f, 1.0f);
    const float r0 = r * r;
    const float xx = x * x;
    F0 = r0 + (1.0f - r0) * (xx * xx * x);
  }
  float F = fres_on ? clampn(F0, 0.0f, 1.0f) : 0.0f;
  // TIR folds transparency into reflectivity only under Fresnel
  if (tir && fres_on) F = 1.0f;
  f.c_trn = tir ? 0.0f : m_trn * (1.0f - F);
  f.c_rfl = m_rfl + m_trn * F;
  if (fres_prop && opaque && (props & PROP_REFLECT)) {
    float f_rf;
    if (props & PROP_METAL) {
      const float rcp = sdiv(1.0f, eta, 0.0f);
      const float ext2 = m_ext * m_ext;
      const float t2 = 2.0f * dot * rcp;
      const float c2 = dot * dot;
      const float gg = rcp * rcp + ext2;
      const float x0 = c2 + gg;
      const float x1 = c2 * gg + 1.0f;
      f_rf = fabsf(-0.5f * (sdiv(x0 + t2, x0 - t2, 1.0f) +
                            sdiv(x1 + t2, x1 - t2, 1.0f)));
    } else {
      f_rf = fabsf(-0.5f * (rs * rs + rp * rp));
    }
    f.c_rfl = m_rfl * f_rf;
  }
  return f;
}

}  // namespace
