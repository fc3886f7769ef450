// Whitted megakernel for NVIDIA Hopper (sm_90a): one thread traces one
// ray, and the warp culls the surfaces its rays cannot reach; once few
// rays of a culled warp are left, the whole warp traces them one at a
// time (the cooperative tail); in PT mode each thread traces path-traced
// samples from a work queue, one after another; the whole traces of the
// main path (whole_kernel) and the path records of training (paths_kernel)
// run kernels of their own, the path records on a persistent grid whose
// blocks hold the scene tables in shared memory.
//
// Replaces the TPU kernels quadray_tpu/ops/pallas_kernel.py
// _trace_tiled (_make_kernel in Whitted mode), _trace_tiled_paths
// (_make_kernel with emit_paths, the path records of trace-replay
// training), _trace_tiled_emit and _trace_tiled_resume (_make_kernel with
// emit_state / resume, the two rounds of two-round retirement) and
// _trace_tiled_pt (_make_kernel with pt, the progressive path tracer),
// with the TPU kernel's bounding-sphere culling in every mode.
// It computes what those kernels compute; its plain twins are
// quadray_tpu_torch/ops/trace.py trace_rays, trace_paths, trace_rays_emit
// and trace_rays_resume (whose Cull is the plain version of the masks)
// and quadray_tpu_torch/ops/pt.py trace_pt:
//   * surface solvers: plane root with the division-free t-window, quadric
//     and two-plane roots with stable b-mixed Vieta roots and the nan-root
//     rule, near-zero determinant root sorting (D_EPS/T_EPS), the conic
//     apex nudge, axis clip boxes, clip programs with ENTER/LEAVE
//     accumulators, the CHECK_SIDE self-skip and the local-origin reuse
//     for the originating surface;
//   * nearest hit with ties broken on the ORIGINAL surface id (the tables
//     are permuted into classes, so the order is invisible);
//   * any-hit shadows with the per-side blocker bits;
//   * shading: ambient, diffuse and specular lights with attenuation,
//     textures through the packed u8 atlas and the decode LUT, gamma
//     decode, exact or Schlick (cfg.schlick, as the jnp tracer takes it;
//     the Pallas kernel ignores the flag) and metal Fresnel with TIR, the
//     branch stack of cfg.stack slots x 15 values (16 in local memory,
//     past that in a device-memory scratch), the cutoff/depth rules and
//     the max_segments cap.
// Surface classes are a run-time switch on sp_i (kind, singularity, clip
// count) where the TPU kernel recompiled per scene structure.
//
// Culling (the Whitted modes; cfg.cull from ops/cuda_kernel.py
// cull_gates, a run-time flag, so one build serves every scene): the
// TPU kernel culls per block of 8192 lanes (pallas_kernel.py:1020-1284)
// because each of its per-surface guards is a scalar SMEM read, which
// pays only per large block; for the same reason it compacts the primary
// segment's candidates into a host-built list per block
// (_build_candidates :2045), so the first segment needs no guard at all.
// Here a guard is a bit of a word every lane holds, and a mask costs a
// few shuffles and ballots, so the unit is the warp and the primary
// segment builds its mask like every other: no host table. Before each
// nearest pass and each shadow pass, the warp bounds its rays (an origin
// box, and a direction cone or an endpoint capsule, reduced with
// __shfl_xor_sync over the lanes that have a ray: warp_bundle); lane j
// tests the bundle against the bounding spheres j, j+32, ... (at most 32
// words: 1024 surfaces) and __ballot_sync packs the reach bits, lane w
// keeping word w. A shadow pass ANDs in the OR of its lanes' shad_msk
// rows (receiver, light: the lsort analog) and a nearest pass the OR of
// its lanes' cont_msk rows (previous hit, side: the lst_p analog; single-
// branch scenes, since a popped branch does not come from the previous
// hit), both with __reduce_or_sync. The surface loops then walk the set
// bits in ascending row order (__shfl_sync of the word, __ffs), so a zero
// word costs one shuffle and the loop bounds are uniform: culling adds
// no divergence, and the primary segment needs no host-side table. The
// nearest hit's ties stay broken on the original id, and a shadow pass
// ends once every lane that needs it is occluded (the reference's
// full-mask early-out). Culling only skips tests that cannot hit, so
// every output bit is the unculled kernel's. The collectives need the
// whole warp, so every lane runs every segment of the loop, with or
// without a ray (`active`), until no lane of the warp has one. A launch
// that does not cull (cfg.cull 0: the gate turned it off, or
// TraceConfig.cull is false) takes the instantiation with CULL false,
// which has no collective: each lane walks every surface in row order
// and leaves the loop once its ray retires, so scenes that do not cull
// pay nothing for the converged loop, and any number of surfaces fits.
//
// The path records (entry point whitted_paths_launch; paths_kernel, a
// __global__ of its own that runs segment<> with EMIT_PATHS, so its f32
// chain is the Whitted modes'): segments are capped at k and the lane of
// each ray writes its own i32 record of every segment it runs to
// paths[it * n + i] (bits 0-11 hit surface original id, 12 side > 0, 13-14
// continuation 0 stop / 1 reflect / 2 transmit, 15 hit, 16+l light l not
// unoccluded-lit), then zeroes the rows after the segment it retired in,
// so the output needs no zeroing. The TPU kernel stages the records in
// VMEM scratch because a dynamic-index store costs it scalar traffic
// (pallas_kernel.py:1880-1882); here the store is direct and coalesced
// (neighbouring threads, neighbouring words). Single-branch scenes only
// (no branch stack) and at most 16 active lights, as on the TPU. The
// TPU kernel keeps the scene tables in VMEM scratch (_scene_specs,
// pallas_kernel.py:2265-2266); here each block of a persistent grid (the
// blocks that fit on the card at once) copies the tables every surface
// test reads (sp_f, sp_i, mat_f, mat_i, lg_f, misc, and cl_f where it
// fits too) into its shared memory, one bulk asynchronous copy a table
// (cp.async.bulk on an mbarrier, Hopper's 1-D TMA path), so the copy is
// paid once a block and not once per 128 rays, and the walks' reads,
// warp-uniform, are broadcasts; a scene whose tables do not fit in
// PATHS_SMEM runs the instantiation that reads them in device memory
// (the host picks by byte count: paths_staging). Each warp takes the next
// 32 consecutive rays from a work queue (one atomicAdd by lane 0), so the
// culled walk's warp bundles are those of a thread a ray, and an SM whose
// warps retire early takes more rays instead of idling through the
// frame's tail. Culled, the segments after the camera's take per-ray
// masks (below) where the warp's keep more than cfg.own_min surfaces, as
// EMIT does. No branch stack, no cooperative tail and no state rows.
//
// Two-round retirement (entry points whitted_emit_launch and
// whitted_resume_launch), single-branch scenes only (no branch stack), as
// on the TPU (pallas_kernel.py:498). EMIT runs at most k1 segments, then
// writes the 3 colours and the 21 values of the resumable ray state of
// every ray to state[row * n + i], in the TPU kernel's row order
// (pallas_kernel.py:2518-2520, 2560-2563): ox oy oz dx dy dz tmn, thr
// r g b, depth osrf oside thru (i32 bits), oloc x y z, active (i32 bits),
// acc r g b. A thread that retired writes what the TPU kernel's
// single-branch update leaves in a stopped lane (pallas_kernel.py:
// 1923-1946): its ray as it was, thru 0 and active 0. A retired lane is a
// fixed point, so that is also the state at segment k1. RESUME takes that
// state and the ascending list idx[0..*count) of the rays still active
// (made on the device, read on the device: no host wait between the
// rounds); ray idx[j] starts its colour sums from the emitted acc
// (pallas_kernel.py:1999-2008), runs at most the remaining max_segments -
// k1 segments and overwrites its colours at idx[j] in the buffer EMIT
// wrote. The f32 chain of every ray is the monolithic kernel's, so the
// frame is bitwise equal to whitted_launch's. The TPU resumes 1024-ray
// blocks that hold an active lane and merges by block (pallas_kernel.py:
// 2624-2642); here round 2 runs only the surviving rays, in one of two
// modes, each its own __global__, both launched, chosen on the device by
// *count against warp_max (the host never reads the count):
//   * sparse (resume_sparse, *count <= warp_max): a warp per surviving
//     ray. Compaction keeps the survivors in frame order, so a warp of 32
//     of them holds rays from all over the frame, whose bundle keeps
//     nearly every surface, and a few hundred such warps leave the card
//     idle. Instead all 32 lanes run one ray's segments in step, as the
//     cooperative tail does (one-ray masks without collectives, the kept
//     surfaces dealt out by rank, the butterfly on (t, original id)), and
//     each ray is a warp of its own on the card.
//   * dense (whitted_kernel RESUME, *count > warp_max): thread j runs ray
//     idx[j], as round 1 runs its rays, with per-ray masks (below) in
//     every segment, so a warp walks the longest of its lanes' own masks,
//     not the union of their rays' surfaces.
// EMIT keeps the warp's masks for segment 0, whose camera rays are
// coherent; its OWN instantiation takes per-ray masks after it, where the
// rays of a warp leave different surfaces in different directions and
// their bundle keeps much of the scene.
//
// Per-ray masks (nearest_own, occluded_own): the warp builds its mask as
// before, and where it keeps more than cfg.own_min surfaces (a launch
// argument: ops/cuda_kernel.py EMIT_OWN_MIN_KEPT, which whole_kernel and
// paths_kernel take too, and RESUME_OWN_MIN_KEPT)
// each lane refines it, word by word in step, by its own cont row (a
// nearest pass) or the receiver's own lsort row (a shadow pass) and by
// its own ray's sphere tests (ray_reaches, the half-line;
// seg_reaches, the segment to the light), then walks the bits it kept in
// ascending row order: the nearest hit keeps its ties on the original id,
// and a lane's shadow walk stops at its first blocker. A lane's tests of
// its own (about 20 FP32 operations a sphere) replace the union's surface
// tests (48-112). A mask built by each lane alone, without the warp's,
// tested every sphere of its row, and lost (PERF.md, section 6).
//
// PT mode (entry point whitted_pt_launch; pt_kernel, then pt_seed_tail):
// the split-tree walk of pt_body/pt_cond (pallas_kernel.py:1365-1669):
// per node the hit's emission, Fresnel weights (TR section with TIR,
// RF-section metal and plain Fresnel), both Fresnel branches at depth <
// PT_SHALLOW and one defensively sampled branch deeper, a cosine-
// hemisphere diffuse child with Russian roulette from depth-5 on,
// siblings on a PT_STACK-slot stack (the Pallas kernel's 16 values a slot
// less the local hit, which PT continuations do not reuse, with depth,
// side, thru and surface packed into one word: 10 words), and the
// 6*(depth+1) node cap. Sample lengths vary widely (on test18 at
// depth 10, 7.5 nodes a sample on average and 30 for the longest), so a
// thread that owned one sample would leave its warp's lanes idle while
// the warp's longest path ran on. pt_kernel is instead a persistent grid
// (as many blocks as fit on the card at once) whose lanes pull samples
// from a work queue, one atomicAdd a warp for all its empty lanes at the
// top of each node iteration, so a lane whose sample retires starts the
// next one at once. The stacks live in shared memory (30 KB a block),
// one column per thread, not in local memory. Each node draws four LCG
// uniforms; the jnp tracer keeps drawing for every lane while any lane of
// the call is active, so every output seed is its input seed advanced
// 4*M draws, M the call's largest node count. A sample's f32 chain does
// not depend on its lane or its neighbours, so regeneration changes no
// output bit: each lane keeps the largest node count of its samples, one
// atomicMax a warp gathers M, and a second small kernel jumps every seed
// ahead 4*M steps (an affine map mod 2^32, by squaring). The Pallas
// kernel counts M per block of 8192 lanes instead; the port follows the
// jnp tracer.
//
// What bounds it on the H100: it reads 28 bytes and writes 12 per ray
// (48 per PT sample with the seeds; EMIT writes 84 more, RESUME reads 84
// and writes 12 per surviving ray), so it is not bandwidth-bound; it is
// latency- and divergence-bound on FP32 ALU work and scattered reads of
// the small scene tables (through __ldg, or in shared memory in the
// path-record kernel). The Whitted modes run one ray per thread, with the
// branch stack in local memory, and walk the surfaces their warp's masks
// keep; a culled PT node walks the surfaces its own ray may reach
// (culling in PT mode, below).
//
// The main path's whole traces (entry point whitted_launch; whole_kernel,
// a __global__ of its own that runs segment<>, so its f32 chain is the
// Whitted modes'): one thread a ray, a grid of ceil(n / 128) blocks, the
// tables in device memory. Culled, the cooperative tail below, and after
// the camera segment per-ray masks (below) where the warp's mask keeps
// more than cfg.own_min surfaces and the launch holds at most own_max
// rays. A persistent grid on a work queue and the tables in shared memory
// were measured against this on the H100 and lost on the scenes that
// reach each walk by default (PERF.md, section 6). A scene that can push
// holds its branch stack in MAX_STACK local slots, or, where a ray may
// hold more (min(stack, max_segments) > MAX_STACK), its slots in a
// device-memory scratch the caller allocates (the DEEP instantiations).
//
// The cooperative tail (the culled whole-trace instantiations,
// whitted_launch's coop_max). A ray is a serial chain of dependent
// segments, and a warp runs as long as its longest ray: in a frame most
// warps retire after one or two segments, while a few rays run to ten,
// and their warps run every one of those segments with one to a few live
// lanes, each lane walking the warp's kept surfaces one after another
// (and the bundle of a few scattered rays keeps many). So at the top of
// each segment the warp ballots its live lanes, and once at most
// cfg.sw (coop_max) are left it leaves the per-lane loop for good: every lane
// saves its loop state in its column of a shared array, and coop_tail
// runs the live rays one after another in ascending lane order, each to
// its end. There every lane loads the owner's state and runs its segments
// in step, so all 32 hold the same values: the masks are one-ray bundles
// built without collectives (warp_mask's ONE); the kept surfaces are
// dealt out by rank (the k-th set bit to lane k mod 32, so a sparse mask
// still spreads over every lane); each lane folds its share with the
// unchanged surface(), and an xor butterfly on (t, original id), the
// fold's own rule, picks the winner, whose Hit is shuffled to every lane;
// the shadow walk is an __any_sync OR that stops at the first round that
// finds a blocker; only the owner's branch stack is written, and a pop is
// shuffled from it. The fold is lexicographic on unique ids, so no output
// bit depends on the split, and each ray counts its own segments against
// max_segments as before. coop_tail is not inlined and the state goes
// through shared memory, so the per-lane loop keeps its 128 registers.
// The chain stays serial; what shortens is each tail segment's
// walk, from K tests one after another to ceil(K / 32) rounds, for the
// price of running the tail's rays one at a time.

// f32 rules the golden frames depend on: build with --fmad=false and
// without fast math; every 3-term contraction is a left-to-right mul/add
// chain in the twin's order; sqrt is __fsqrt_rn and rsqrt __frsqrt_rn
// (both correctly rounded), and the specular power is expf(p * logf(c));
// the hemisphere's cos and sin are taken in double and rounded once.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int PF = 44, SI = 8, CF = 22, MF = 14, LF = 10, MI = 5;
constexpr int MAX_STACK = 16;
constexpr int SLOT = 15;   // values per branch-stack slot
// the differentiable route's tape (ops/diff.py): entry-state floats a
// bounce, and the flags word's bits
constexpr int TAPE_F = 12;
constexpr unsigned T_SRF = 0xFFFFu, T_HIT = 1u << 16, T_SIDE = 1u << 17,
                   T_OWN = 1u << 18, T_NUDGE = 1u << 19, T_PUSH = 1u << 22,
                   T_POP = 1u << 23, T_ACTIVE = 1u << 28;
constexpr int T_KIND_SHIFT = 20, T_SLOT_SHIFT = 24;

// sp_i columns
constexpr int SI_KIND = 0, SI_MO = 1, SI_MI = 2, SI_BLK = 3, SI_SING = 4,
              SI_NCL = 5, SI_OID = 6;

// clip program opcodes
constexpr int CLIP_SURF = 1, CLIP_ENTER = 2, CLIP_LEAVE = 3;

struct Tables {
  const float* sp_f;
  const int* sp_i;
  const float* cl_f;
  const float* mat_f;
  const int* mat_i;
  const float* lg_f;
  const float* misc;
  const int* tex_pk;
  const float* tex_lut;
  const float* bsph;   // (4, nsl) bounding spheres: cx, cy, cz, radius
  const int* shad;     // (rows, nl * nw) lsort words
  const int* cont;     // (rows, 2 * nw) continuation words, side > 0 first
  int ns;   // real surfaces: a prefix of the permuted rows
  int nc;   // clip program width
  int nl;   // active lights: a prefix of the light rows
  int nw;   // words of a shad/cont row: ceil(rows / 32)
  int nsl;  // length of a bsph row: rows rounded up to 128
};

// cfg.cull bits (ops/cuda_kernel.py CullGates.flags)
constexpr int CULL_REACH = 1, CULL_LSORT = 2, CULL_CONT = 4;
// the culled Whitted modes' surface masks: one word per lane, so at most
// 1024 real surfaces (ops/cuda_kernel.py MAX_SURFACES)
constexpr int MAX_WORDS = 32;

struct Cfg {
  int depth, max_segments, stack;
  float cutoff;
  int cull;
  // the mode's switch: WHOLE, coop_max (the cooperative tail, 0 never);
  // RESUME, warp_max (the most survivors that run a warp per ray)
  int sw;
  // the rounds' per-ray masks refine a warp's mask that keeps more than
  // this many surfaces (nearest_own, occluded_own)
  int own_min;
  // Schlick's F on the transparency path (TraceConfig.schlick), in every
  // mode (the jnp tracer's; the Pallas kernel ignores the flag)
  int schlick;
};

constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

// x - p, then m . (x - p): world -> canonical for the 12 floats at t.
// SM, here and below: the scene tables sp_f, sp_i, mat_f, mat_i, lg_f and
// misc are the copies in the block's shared memory (paths_kernel), cl_f
// there or in device memory (common.cuh ldt)
template <bool SM>
__device__ __forceinline__ void to_local(const float* t, float x, float y,
                                         float z, float& lx, float& ly,
                                         float& lz) {
  float rx = x - ldt<SM>(t, 0), ry = y - ldt<SM>(t, 1),
        rz = z - ldt<SM>(t, 2);
  lx = ldt<SM>(t, 3) * rx + ldt<SM>(t, 4) * ry + ldt<SM>(t, 5) * rz;
  ly = ldt<SM>(t, 6) * rx + ldt<SM>(t, 7) * ry + ldt<SM>(t, 8) * rz;
  lz = ldt<SM>(t, 9) * rx + ldt<SM>(t, 10) * ry + ldt<SM>(t, 11) * rz;
}

// implicit value at a canonical point; q points at sx sy sz jx jy jz sw
template <bool SM>
__device__ __forceinline__ float implicit(const float* q, bool plane,
                                          float x, float y, float z) {
  if (plane) return z;
  return ldt<SM>(q, 0) * x * x + ldt<SM>(q, 1) * y * y +
         ldt<SM>(q, 2) * z * z -
         2.0f * (ldt<SM>(q, 3) * x + ldt<SM>(q, 4) * y +
                 ldt<SM>(q, 5) * z) -
         ldt<SM>(q, 6);
}

// Custom clip program (CC_cyc, tracer.cpp:1939-2160) at world point w.
// Called only with mask == true: programs from compile_scene are SURF
// ANDs and ENTER..LEAVE segments, after which mask <= saved, so a false
// mask stays false and needs no evaluation.
template <bool SM>
__device__ bool clip_program(const Tables& T, int s, int ncl, float wx,
                             float wy, float wz) {
  bool mask = true, saved = true;
  for (int j = 0; j < ncl; ++j) {
    const float* c = T.cl_f + (size_t)(s * T.nc + j) * CF;
    int op = (int)ldt<SM>(c, 21);
    if (op == CLIP_ENTER) {
      saved = mask;
      mask = true;
    } else if (op == CLIP_LEAVE) {
      mask = saved && !mask;
    } else if (op == CLIP_SURF) {
      float cx, cy, cz;
      to_local<SM>(c, wx, wy, wz, cx, cy, cz);
      float val = implicit<SM>(c + 12, ldt<SM>(c, 19) == 1.0f, cx, cy, cz);
      bool keep = ldt<SM>(c, 20) >= 0.0f ? (val <= 0.0f) : (val >= 0.0f);
      mask = mask && keep;
    }
  }
  return mask;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmn, tmx;
  int osrf, oside;   // originating surface (original id, -1 none), side
  bool thru;         // refracted continuation (PASS_THRU)
  float olx, oly, olz;  // local hit on the originating surface
  int orow;          // its permuted row for the cont mask, -1: none
};

struct Hit {
  float t;
  int srf, side, mat;
  int row;           // permuted table row of the hit surface
  float wx, wy, wz;  // world hit
  float nx, ny, nz;  // unnormalized world normal, facing the ray
  float hx, hy, hz;  // local hit (texture UV, continuation local origin)
  bool hm;           // the apex nudge moved the hit (the tape's NUDGE bit)
};

// One surface against one ray. SHADOW: returns true if it blocks the ray
// (any-hit); otherwise folds its nearest valid root into `best`. LOCAL:
// the originating surface takes r.ol* as the ray's local origin (the
// Whitted modes); else it transforms the world origin like any other.
template <bool SHADOW, bool LOCAL, bool SM = false>
__device__ bool surface(const Tables& T, int s, const Ray& r, Hit& best) {
  const float* P = T.sp_f + (size_t)s * PF;
  const auto pf = [P](int k) { return ldt<SM>(P, k); };
  const int* I = T.sp_i + (size_t)s * SI;
  const int kind = ldt<SM>(I, SI_KIND);
  const int origid = ldt<SM>(I, SI_OID);
  const int ncl = ldt<SM>(I, SI_NCL);
  const int blk = SHADOW ? ldt<SM>(I, SI_BLK) : 0;

  float lx, ly, lz;
  to_local<SM>(P, r.ox, r.oy, r.oz, lx, ly, lz);
  const float ex = pf(3) * r.dx + pf(4) * r.dy + pf(5) * r.dz;
  const float ey = pf(6) * r.dx + pf(7) * r.dy + pf(8) * r.dz;
  const float ez = pf(9) * r.dx + pf(10) * r.dy + pf(11) * r.dz;
  // secondary-ray local-diff reuse (tracer.cpp:1350-1373)
  const bool same = r.osrf == origid;
  if (LOCAL && same) {
    lx = r.olx;
    ly = r.oly;
    lz = r.olz;
  }
  const float cminx = pf(19), cminy = pf(20), cminz = pf(21);
  const float cmaxx = pf(22), cmaxy = pf(23), cmaxz = pf(24);

  if (kind == 1) {
    // plane root + ray-sign side (tracer.cpp:4062-4210) with the
    // division-free sign-aware t-window
    const float t = sdiv(-lz, ez, BIG);
    const int side = ez < 0.0f ? 1 : -1;
    const bool pos_d = ez > 0.0f;
    const float tmin_d = r.tmn * ez, tmax_d = r.tmx * ez;
    bool v = (ez != 0.0f) && (pos_d ? (-lz > tmin_d) : (-lz < tmin_d)) &&
             (pos_d ? (-lz < tmax_d) : (-lz > tmax_d));
    const float hx = lx + t * ex, hy = ly + t * ey, hz = lz + t * ez;
    const float wx = r.ox + t * r.dx, wy = r.oy + t * r.dy,
                wz = r.oz + t * r.dz;
    // (t < BIG: a window-valid root whose division fell back to BIG for
    // |ez| < 1e-30 is invalid, as in the jnp tracer)
    v = v && t < BIG && hx >= cminx && hx <= cmaxx && hy >= cminy &&
        hy <= cmaxy && hz >= cminz && hz <= cmaxz;
    // CHECK_SIDE exact self-intersection skip
    v = v && (!same || (r.thru != (side == r.oside)));
    if (v && ncl > 0) v = clip_program<SM>(T, s, ncl, wx, wy, wz);
    if (SHADOW) return v && (blk & (side > 0 ? 1 : 2));
    if (v && (t < best.t || (t == best.t && origid < best.srf))) {
      const float sf = (float)side;
      best.t = t;
      best.srf = origid;
      best.side = side;
      best.mat = ldt<SM>(I, side > 0 ? SI_MO : SI_MI);
      best.row = s;
      best.wx = wx; best.wy = wy; best.wz = wz;
      best.nx = pf(9) * sf;
      best.ny = pf(10) * sf;
      best.nz = pf(11) * sf;
      best.hx = hx; best.hy = hy; best.hz = hz;
      best.hm = false;
    }
    return false;
  }

  // ---- quadric / two-plane: F(o + t d) = a t^2 + 2 b t + c
  const float sx = pf(12), sy = pf(13), sz = pf(14);
  const float jx = pf(15), jy = pf(16), jz = pf(17);
  const float sw = pf(18);
  const float a = sx * ex * ex + sy * ey * ey + sz * ez * ez;
  const float b = (sx * lx - jx) * ex + (sy * ly - jy) * ey +
                  (sz * lz - jz) * ez;
  const float c = sx * lx * lx + sy * ly * ly + sz * lz * lz -
                  2.0f * (jx * lx + jy * ly + jz * lz) - sw;
  // two-plane exact factored determinant (tracer.cpp:4239-4246)
  float disc;
  if (kind == 3) {
    const float cross = lx * ez - lz * ex;
    disc = fabsf(sx * sz) * cross * cross;
  } else {
    disc = b * b - a * c;
  }
  const bool quad_ok = disc >= 0.0f;
  const float sq = disc > 0.0f ? __fsqrt_rn(disc) : 0.0f;
  // stable b-mixed roots (tracer.cpp:4518-4547): slot a = entering /
  // outer side, slot b = leaving / inner side, structurally
  const float qq = -(b + sgnf(b) * sq);
  const bool b_pos = b > 0.0f;
  bool ok1, ok2;
  float t1 = root(b_pos ? qq : c, b_pos ? a : qq, ok1);
  float t2 = root(b_pos ? c : qq, b_pos ? qq : a, ok2);
  // near-zero determinant root sorting (tracer.cpp:4572-4623)
  const bool dmask = quad_ok && disc < D_EPS;
  const float sgn_a = sgnf(a);
  const float u = (t1 - t2) * sgn_a;
  float tdff = (u >= 0.0f ? -0.5f * u - fabsf(T_EPS * t1) : 0.0f) * sgn_a;
  if (!(dmask && ok1 && ok2)) tdff = 0.0f;
  t1 = t1 + tdff;
  t2 = t2 - tdff;
  const float root_a = (quad_ok && ok1) ? t1 : BIG;
  const float root_b = (quad_ok && ok2) ? t2 : BIG;

  // conic singularity (CC_glb, tracer.cpp:1706-1860)
  const int sing = ldt<SM>(I, SI_SING);
  const bool cyl = sing == 2;
  float inv_r = 0.0f, sqrt_ratio = 0.0f;
  if (sing > 0) {
    const float ratio = fabsf(sdiv(sx + (cyl ? 0.0f : sy), sz, 0.0f));
    inv_r = T_EPS * __frsqrt_rn(maxn(ratio + (cyl ? 1.0f : 2.0f), 1e-30f));
    sqrt_ratio = __fsqrt_rn(ratio);
  }

  float h[2][9];          // per slot: local hit, world hit, gradient
  bool valid[2], nudged[2];
  const float roots[2] = {root_a, root_b};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float t = roots[k];
    float hx = lx + t * ex, hy = ly + t * ey, hz = lz + t * ez;
    float wx = r.ox + t * r.dx, wy = r.oy + t * r.dy, wz = r.oz + t * r.dz;
    nudged[k] = sing > 0 && dmask && (hx * hx + hy * hy + hz * hz < T_EPS);
    if (nudged[k]) {
      const bool a_neg = a < 0.0f;
      const float ij_flip = (k == 1 && !a_neg) ? -1.0f : 1.0f;
      const float k_flip = (k == 0 && a_neg) ? -1.0f : 1.0f;
      const float ai = sgnf(lx) * ij_flip * inv_r;
      const float aj = cyl ? 0.0f : sgnf(ly) * ij_flip * inv_r;
      const float ak = sgnf(lz) * k_flip * sqrt_ratio * inv_r;
      hx = ai; hy = aj; hz = ak;
      wx = pf(0) + (pf(25) * ai + pf(26) * aj + pf(27) * ak);
      wy = pf(1) + (pf(28) * ai + pf(29) * aj + pf(30) * ak);
      wz = pf(2) + (pf(31) * ai + pf(32) * aj + pf(33) * ak);
    }
    const int side = k == 0 ? 1 : -1;
    bool v = t > r.tmn && t < r.tmx && t < BIG;
    v = v && hx >= cminx && hx <= cmaxx && hy >= cminy && hy <= cmaxy &&
        hz >= cminz && hz <= cmaxz;
    v = v && (!same || (r.thru != (side == r.oside)));
    if (v && ncl > 0) v = clip_program<SM>(T, s, ncl, wx, wy, wz);
    valid[k] = v;
    if (SHADOW) {
      if (v && (blk & (k == 0 ? 1 : 2))) return true;
      continue;
    }
    h[k][0] = hx; h[k][1] = hy; h[k][2] = hz;
    h[k][3] = wx; h[k][4] = wy; h[k][5] = wz;
    h[k][6] = sx * hx - jx;
    h[k][7] = sy * hy - jy;
    h[k][8] = sz * hz - jz;
  }
  if (SHADOW) return false;

  // per-surface nearest valid root, then one compare against the best;
  // the slot is picked by selects, not by an index, so that h stays in
  // registers
  const bool pick_b = valid[1] && (!valid[0] || root_b < root_a);
  const auto hk = [&](int j) { return pick_b ? h[1][j] : h[0][j]; };
  if (!(pick_b ? valid[1] : valid[0])) return false;
  const float t = pick_b ? root_b : root_a;
  if (!(t < BIG && (t < best.t || (t == best.t && origid < best.srf))))
    return false;
  const int side = pick_b ? -1 : 1;
  const float sf = (float)side;
  const float gx = hk(6), gy = hk(7), gz = hk(8);
  // world normal = inv^T grad, flipped to the hit side
  best.t = t;
  best.srf = origid;
  best.side = side;
  best.mat = ldt<SM>(I, side > 0 ? SI_MO : SI_MI);
  best.row = s;
  best.wx = hk(3); best.wy = hk(4); best.wz = hk(5);
  best.nx = (pf(3) * gx + pf(6) * gy + pf(9) * gz) * sf;
  best.ny = (pf(4) * gx + pf(7) * gy + pf(10) * gz) * sf;
  best.nz = (pf(5) * gx + pf(8) * gy + pf(11) * gz) * sf;
  best.hx = hk(0); best.hy = hk(1); best.hz = hk(2);
  best.hm = pick_b ? nudged[1] : nudged[0];
  return false;
}

__device__ __forceinline__ void no_hit(Hit& best) {
  best.t = BIG;
  best.srf = 0x7FFFFFF;
  best.side = 1;
  best.mat = 0;
  best.row = 0;
  best.wx = best.wy = best.wz = 0.0f;
  best.nx = best.ny = best.nz = 0.0f;
  best.hx = best.hy = best.hz = 0.0f;
  best.hm = false;
}

// nearest hit over every surface (PT nodes)
template <bool LOCAL, bool SM = false>
__device__ void nearest_all(const Tables& T, const Ray& r, Hit& best) {
  no_hit(best);
  for (int s = 0; s < T.ns; ++s) surface<false, LOCAL, SM>(T, s, r, best);
}

// ---- culling: the warp's masks (file header) ----------------------------

// NaN-propagating min/max (torch.minimum / torch.maximum)
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float add_f(float a, float b) { return a + b; }

// v reduced over the warp by the xor butterfly (offsets 16 .. 1); every
// lane ends with the same bits (ops/trace.py _butterfly). ONE: every lane
// holds the same ray (the cooperative tail), so v is its own reduction (a
// sum of 32 copies is 32 v, which the bundle's axis normalises away: the
// power-of-two scale changes no bit of it)
template <bool ONE, typename Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
  if (ONE) return v;
  for (int k = 16; k > 0; k >>= 1) v = op(v, __shfl_xor_sync(FULL_WARP, v, k));
  return v;
}

// a warp's rays: origin ball (c, r) and either a cone (axis a, cosw,
// sinw) or a capsule to the endpoints' ball (a = c1 - c, uu = |a|^2,
// brad the capsule radius); ops/trace.py bundle_reach, op for op
struct Bundle {
  float cx, cy, cz, r, ax, ay, az, cosw, sinw, uu, brad;
};

// centre and half diagonal of the box of the points of the lanes that
// are on (every lane calls it)
template <bool ONE>
__device__ __forceinline__ void warp_ball(bool on, float x, float y, float z,
                                          float& cx, float& cy, float& cz,
                                          float& rad) {
  const float xm = warp_reduce<ONE>(on ? x : BIG, min_nan);
  const float xM = warp_reduce<ONE>(on ? x : -BIG, max_nan);
  const float ym = warp_reduce<ONE>(on ? y : BIG, min_nan);
  const float yM = warp_reduce<ONE>(on ? y : -BIG, max_nan);
  const float zm = warp_reduce<ONE>(on ? z : BIG, min_nan);
  const float zM = warp_reduce<ONE>(on ? z : -BIG, max_nan);
  cx = 0.5f * (xm + xM);
  cy = 0.5f * (ym + yM);
  cz = 0.5f * (zm + zM);
  const float ex = xM - xm, ey = yM - ym, ez = zM - zm;
  rad = 0.5f * __fsqrt_rn(ex * ex + ey * ey + ez * ez);
}

template <bool SHADOW, bool ONE>
__device__ Bundle warp_bundle(bool on, const Ray& r) {
  Bundle b;
  warp_ball<ONE>(on, r.ox, r.oy, r.oz, b.cx, b.cy, b.cz, b.r);
  b.r = b.r * 1.0005f + 1e-4f;
  if (SHADOW) {
    float c1x, c1y, c1z, r1;
    warp_ball<ONE>(on, r.ox + r.dx, r.oy + r.dy, r.oz + r.dz, c1x, c1y, c1z,
                   r1);
    b.ax = c1x - b.cx;
    b.ay = c1y - b.cy;
    b.az = c1z - b.cz;
    b.uu = b.ax * b.ax + b.ay * b.ay + b.az * b.az;
    b.brad = maxn(b.r, r1 * 1.0005f + 1e-4f);
  } else {
    const float il =
        __frsqrt_rn(maxn(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-30f));
    const float hx = r.dx * il, hy = r.dy * il, hz = r.dz * il;
    const float sx = warp_reduce<ONE>(on ? hx : 0.0f, add_f);
    const float sy = warp_reduce<ONE>(on ? hy : 0.0f, add_f);
    const float sz = warp_reduce<ONE>(on ? hz : 0.0f, add_f);
    const float an = __frsqrt_rn(maxn(sx * sx + sy * sy + sz * sz, 1e-30f));
    b.ax = sx * an;
    b.ay = sy * an;
    b.az = sz * an;
    const float cosmin = warp_reduce<ONE>(
        on ? hx * b.ax + hy * b.ay + hz * b.az : 1.0f, min_nan);
    b.cosw = clampn(cosmin - 1e-4f, -1.0f, 1.0f);
    b.sinw = __fsqrt_rn(maxn(1.0f - b.cosw * b.cosw, 0.0f));
  }
  return b;
}

// may a ray of the bundle reach sphere s? NaN and inf come out as "reach"
template <bool SHADOW>
__device__ __forceinline__ bool reaches(const Tables& T, const Bundle& b,
                                        int s) {
  const float lcx = ldf(T.bsph, s) - b.cx;
  const float lcy = ldf(T.bsph, T.nsl + s) - b.cy;
  const float lcz = ldf(T.bsph, 2 * T.nsl + s) - b.cz;
  const float srs = ldf(T.bsph, 3 * T.nsl + s);
  if (SHADOW) {
    const float tp = clampn((lcx * b.ax + lcy * b.ay + lcz * b.az) /
                                maxn(b.uu, 1e-30f),
                            0.0f, 1.0f);
    const float qx = lcx - tp * b.ax, qy = lcy - tp * b.ay,
                qz = lcz - tp * b.az;
    const float re = srs + b.brad;
    return !(qx * qx + qy * qy + qz * qz > re * re);
  }
  const float d_ax = lcx * b.ax + lcy * b.ay + lcz * b.az;
  const float dist2 = lcx * lcx + lcy * lcy + lcz * lcz;
  const float perp = __fsqrt_rn(maxn(dist2 - d_ax * d_ax, 0.0f));
  return !(perp * b.cosw - d_ax * b.sinw > srs + b.r);
}

// The warp's mask of the surfaces to test in a nearest (SHADOW false) or
// shadow pass of the lanes that are `on`, for the ray r of each: lane w
// returns word w. row: this lane's static mask words (its cont or shad
// row), nullptr for all bits; read only when the gate is on. Every lane
// calls it with the same gates. ONE: every lane holds the same ray and
// row (the cooperative tail): a one-ray bundle, without the collectives.
template <bool SHADOW, bool ONE, bool SM = false>
__device__ unsigned warp_mask(const Tables& T, int gates, bool on,
                              const Ray& r, const int* row) {
  const unsigned lane = threadIdx.x & 31u;
  if (ONE ? !on : !__any_sync(FULL_WARP, on)) return 0u;
  const bool reach_on = gates & CULL_REACH;
  const bool rows_on = gates & (SHADOW ? CULL_LSORT : CULL_CONT);
  Bundle b;
  if (reach_on) b = warp_bundle<SHADOW, ONE>(on, r);
  unsigned mine = 0u;
  const int words = (T.ns + 31) >> 5;
  for (int w = 0; w < words; ++w) {
    const int s = w * 32 + (int)lane;
    bool keep = s < T.ns;
    if (SHADOW && keep) keep = ldt<SM>(T.sp_i + (size_t)s * SI, SI_BLK) != 0;
    if (reach_on && keep) keep = reaches<SHADOW>(T, b, s);
    unsigned word = __ballot_sync(FULL_WARP, keep);
    if (rows_on)
      word &= ONE ? (row ? (unsigned)ldi(row, w) : FULL_WARP)
                  : __reduce_or_sync(FULL_WARP,
                                     !on    ? 0u
                                     : row ? (unsigned)ldi(row, w)
                                           : FULL_WARP);
    if ((int)lane == w) mine = word;
  }
  return mine;
}

// any blocker between the hit point and the light (t in (0, 1)), every
// blocker in row order (the unculled walk)
template <bool SM>
__device__ bool occluded_all(const Tables& T, const Ray& r) {
  Hit unused;
  for (int s = 0; s < T.ns; ++s) {
    if (ldt<SM>(T.sp_i + (size_t)s * SI, SI_BLK) == 0) continue;
    if (surface<true, true, SM>(T, s, r, unused)) return true;
  }
  return false;
}

// nearest hit over the surfaces of the warp's mask (lane w holds word w);
// a lane that is not `on` walks with the warp and tests nothing
template <bool SM>
__device__ void nearest_masked(const Tables& T, const Ray& r, bool on,
                               unsigned mine, Hit& best) {
  no_hit(best);
  const int words = (T.ns + 31) >> 5;
  for (int w = 0; w < words; ++w) {
    unsigned word = __shfl_sync(FULL_WARP, mine, w);
    while (word) {
      const int s = w * 32 + __ffs(word) - 1;
      word &= word - 1u;
      if (on) surface<false, true, SM>(T, s, r, best);
    }
  }
}

// any blocker of the warp's shadow mask between the hit point and the
// light (t in (0, 1)), for the lanes that `need` it; the warp stops once
// every such lane is occluded
template <bool SM>
__device__ bool occluded_masked(const Tables& T, const Ray& r, bool need,
                                unsigned mine) {
  bool occ = false;
  const int words = (T.ns + 31) >> 5;
  for (int w = 0; w < words; ++w) {
    unsigned word = __shfl_sync(FULL_WARP, mine, w);
    while (word) {
      const int s = w * 32 + __ffs(word) - 1;
      word &= word - 1u;
      Hit unused;
      if (need && !occ) occ = surface<true, true, SM>(T, s, r, unused);
      if (!__any_sync(FULL_WARP, need && !occ)) return occ;
    }
  }
  return occ;
}

// ---- the cooperative tail: one ray walked by the whole warp (file header)

// bit position of the set bit of rank k (from 0, ascending) of w; k <
// __popc(w)
__device__ __forceinline__ int nth_bit(unsigned w, int k) {
  int pos = 0;
  for (int sh = 16; sh > 0; sh >>= 1) {
    const unsigned lo = w & ((1u << sh) - 1u);
    const int c = __popc(lo);
    if (k >= c) {
      k -= c;
      w >>= sh;
      pos += sh;
    } else {
      w = lo;
    }
  }
  return pos;
}

// The kept surfaces of a warp mask (lane w holds word w) dealt out by
// rank: the kept bit of rank g goes to lane g mod 32, so a sparse mask
// still spreads over every lane. kept_ranks returns, on lane w, the kept
// bits of words 0..w; kept_row the row of rank g, -1 for g >= the count
// (every lane calls both: their shuffles need the whole warp).
__device__ __forceinline__ int kept_ranks(unsigned mine) {
  const int lane = (int)(threadIdx.x & 31u);
  int incl = __popc(mine);
  for (int k = 1; k < 32; k <<= 1) {
    const int v = __shfl_up_sync(FULL_WARP, incl, k);
    if (lane >= k) incl += v;
  }
  return incl;
}

__device__ __forceinline__ int kept_row(unsigned mine, int incl, int g) {
  int w = 0;   // the first word whose count passes g (31 if none does)
  for (int step = 16; step > 0; step >>= 1)
    if (__shfl_sync(FULL_WARP, incl, w + step - 1) <= g) w += step;
  const unsigned word = __shfl_sync(FULL_WARP, mine, w);
  const int below = __shfl_sync(FULL_WARP, incl, w) - __popc(word);
  return g - below < __popc(word) ? w * 32 + nth_bit(word, g - below) : -1;
}

// nearest hit of the ray r, which every lane holds, over the surfaces of
// its mask: each lane folds its share with surface() (ties on the
// original id), then the warp reduces (t, original id) lexicographically
// by the xor butterfly, the fold's own rule, so the winner is the serial
// walk's, whatever the split; every lane ends with its Hit. A lane with
// no share keeps no_hit (t BIG, srf 0x7FFFFFF), which loses to any hit.
__device__ void nearest_coop(const Tables& T, const Ray& r, unsigned mine,
                             Hit& best) {
  no_hit(best);
  const int incl = kept_ranks(mine);
  const int total = __shfl_sync(FULL_WARP, incl, 31);
  for (int g0 = 0; g0 < total; g0 += 32) {
    const int s = kept_row(mine, incl, g0 + (int)(threadIdx.x & 31u));
    if (s >= 0) surface<false, true>(T, s, r, best);
  }
  float t = best.t;
  int srf = best.srf;
  for (int k = 16; k > 0; k >>= 1) {
    const float ot = __shfl_xor_sync(FULL_WARP, t, k);
    const int os = __shfl_xor_sync(FULL_WARP, srf, k);
    if (ot < t || (ot == t && os < srf)) {
      t = ot;
      srf = os;
    }
  }
  // one lane tested the winner (original ids are unique); with no hit,
  // every lane holds no_hit and lane 0 gives it
  const int src = __ffs(__ballot_sync(FULL_WARP, best.srf == srf)) - 1;
  best.t = t;
  best.srf = srf;
  best.side = __shfl_sync(FULL_WARP, best.side, src);
  best.mat = __shfl_sync(FULL_WARP, best.mat, src);
  best.row = __shfl_sync(FULL_WARP, best.row, src);
  best.wx = __shfl_sync(FULL_WARP, best.wx, src);
  best.wy = __shfl_sync(FULL_WARP, best.wy, src);
  best.wz = __shfl_sync(FULL_WARP, best.wz, src);
  best.nx = __shfl_sync(FULL_WARP, best.nx, src);
  best.ny = __shfl_sync(FULL_WARP, best.ny, src);
  best.nz = __shfl_sync(FULL_WARP, best.nz, src);
  best.hx = __shfl_sync(FULL_WARP, best.hx, src);
  best.hy = __shfl_sync(FULL_WARP, best.hy, src);
  best.hz = __shfl_sync(FULL_WARP, best.hz, src);
}

// any blocker of the shadow ray r, which every lane holds, in its mask:
// the blockers dealt out as in nearest_coop, an OR over the lanes that
// stops at the first round that finds one; every lane returns it
__device__ bool occluded_coop(const Tables& T, const Ray& r, unsigned mine) {
  const int incl = kept_ranks(mine);
  const int total = __shfl_sync(FULL_WARP, incl, 31);
  for (int g0 = 0; g0 < total; g0 += 32) {
    const int s = kept_row(mine, incl, g0 + (int)(threadIdx.x & 31u));
    Hit unused;
    const bool occ = s >= 0 && surface<true, true>(T, s, r, unused);
    if (__any_sync(FULL_WARP, occ)) return true;
  }
  return false;
}

// ---- per-ray masks (file header): EMIT after segment 0, RESUME dense ---

// may the ray from o along the unit direction dh (the half-line o + t dh,
// t >= 0) reach bounding sphere s? Its centre c is within the radius of
// the line (|c - o|^2 - ((c - o).dh)^2) and not behind o by more than
// the radius, with the radius widened by 1e-4 and the squares by 1e-5
// |c - o|^2 for f32 rounding; NaN and inf come out as "reach". The plain
// version is ops/trace.py ray_reach, op for op.
__device__ __forceinline__ bool ray_reaches(const Tables& T, const Ray& r,
                                            float dhx, float dhy, float dhz,
                                            int s) {
  const float lcx = ldf(T.bsph, s) - r.ox;
  const float lcy = ldf(T.bsph, T.nsl + s) - r.oy;
  const float lcz = ldf(T.bsph, 2 * T.nsl + s) - r.oz;
  const float re = ldf(T.bsph, 3 * T.nsl + s) + 1e-4f;
  const float d_ax = lcx * dhx + lcy * dhy + lcz * dhz;
  const float dist2 = lcx * lcx + lcy * lcy + lcz * lcz;
  const float lim = re * re + 1e-5f * dist2;
  return !(dist2 - d_ax * d_ax > lim || (d_ax < 0.0f && d_ax * d_ax > lim));
}

// may the shadow segment from o to o + d (t in [0, 1], d unnormalised: the
// hit point to the light) reach bounding sphere s? The point of the
// segment nearest its centre c (t clamped to [0, 1]) lies within the
// radius, widened by 1e-4 and the squares by 1e-5 (|c - o|^2 + |d|^2) for
// f32 rounding; NaN and inf come out as "reach". The plain version is
// ops/trace.py seg_reach, op for op.
__device__ __forceinline__ bool seg_reaches(const Tables& T, const Ray& r,
                                            int s) {
  const float lcx = ldf(T.bsph, s) - r.ox;
  const float lcy = ldf(T.bsph, T.nsl + s) - r.oy;
  const float lcz = ldf(T.bsph, 2 * T.nsl + s) - r.oz;
  const float re = ldf(T.bsph, 3 * T.nsl + s) + 1e-4f;
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float tp = clampn(
      (lcx * r.dx + lcy * r.dy + lcz * r.dz) / maxn(dd, 1e-30f), 0.0f, 1.0f);
  const float qx = lcx - tp * r.dx, qy = lcy - tp * r.dy,
              qz = lcz - tp * r.dz;
  const float dist2 = lcx * lcx + lcy * lcy + lcz * lcz;
  const float lim = re * re + 1e-5f * (dist2 + dd);
  return !(qx * qx + qy * qy + qz * qz > lim);
}

// the surfaces a warp's mask keeps, on every lane (lane w holds word w)
__device__ __forceinline__ int warp_kept(unsigned mine) {
  return (int)__reduce_add_sync(FULL_WARP, (unsigned)__popc(mine));
}

// this lane's own bits of the warp's mask word w (wword): those its own
// static row (cont or lsort; nullptr for all bits) keeps and, where the
// reach gate is on, whose spheres its own ray may reach (SHADOW: the
// segment; else the half-line along dh). The loop runs over the warp's
// bits, the same for every lane.
template <bool SHADOW>
__device__ __forceinline__ unsigned own_bits(const Tables& T, int gates,
                                             const Ray& r, float dhx,
                                             float dhy, float dhz,
                                             const int* row, int w,
                                             unsigned wword) {
  unsigned m = row ? wword & (unsigned)ldi(row, w) : wword;
  if (gates & CULL_REACH) {
    for (unsigned c = wword; c; c &= c - 1u) {
      const int b = __ffs(c) - 1;
      const int s = 32 * w + b;
      if (((m >> b) & 1u) && !(SHADOW ? seg_reaches(T, r, s)
                                       : ray_reaches(T, r, dhx, dhy, dhz, s)))
        m &= ~(1u << b);
    }
  }
  return m;
}

// nearest hit over this lane's own mask (crow: its cont row, nullptr for
// all bits) within the warp's (lane w holds word w): word by word, the
// lanes refine each word in step, then each walks its own kept bits; a
// lane that is not `on` tests nothing
template <bool SM>
__device__ void nearest_own(const Tables& T, int gates, const Ray& r,
                            bool on, unsigned mine, const int* crow,
                            Hit& best) {
  no_hit(best);
  const float il =
      __frsqrt_rn(maxn(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-30f));
  const float dhx = r.dx * il, dhy = r.dy * il, dhz = r.dz * il;
  const int words = (T.ns + 31) >> 5;
  for (int w = 0; w < words; ++w) {
    const unsigned wword = __shfl_sync(FULL_WARP, mine, w);
    if (!on) continue;
    unsigned word = own_bits<false>(T, gates, r, dhx, dhy, dhz, crow, w,
                                    wword);
    while (word) {
      const int s = w * 32 + __ffs(word) - 1;
      word &= word - 1u;
      surface<false, true, SM>(T, s, r, best);
    }
  }
}

// any blocker of this lane's own shadow mask (srow: the receiver's lsort
// row for the light) within the warp's, for the lanes that `need` it: a
// lane's walk stops at its first blocker, the warp once every such lane
// is occluded
template <bool SM>
__device__ bool occluded_own(const Tables& T, int gates, const Ray& r,
                             bool need, unsigned mine, const int* srow) {
  bool occ = false;
  const int words = (T.ns + 31) >> 5;
  for (int w = 0; w < words; ++w) {
    const unsigned wword = __shfl_sync(FULL_WARP, mine, w);
    if (need && !occ) {
      unsigned word = own_bits<true>(T, gates, r, 0.0f, 0.0f, 0.0f, srow, w,
                                     wword);
      while (word) {
        const int s = w * 32 + __ffs(word) - 1;
        word &= word - 1u;
        Hit unused;
        if (surface<true, true, SM>(T, s, r, unused)) {
          occ = true;
          break;
        }
      }
    }
    if (!__any_sync(FULL_WARP, need && !occ)) return occ;
  }
  return occ;
}

// material at a hit: properties, colour (texture through the packed atlas
// and the decode LUT, then the gamma decode) and the material row; texel,
// where given, the atlas index read (-1: none)
template <bool SM = false>
__device__ __forceinline__ int hit_material(const Tables& T, const Hit& hb,
                                            bool gamma_on, float mc[3],
                                            const float*& M,
                                            int* texel = nullptr) {
  M = T.mat_f + (size_t)hb.mat * MF;
  const int* Mi = T.mat_i + (size_t)hb.mat * MI;
  const int props = ldt<SM>(Mi, 0);
  mc[0] = ldt<SM>(M, 0); mc[1] = ldt<SM>(M, 1); mc[2] = ldt<SM>(M, 2);
  const int base = ldt<SM>(Mi, 1);
  if ((props & PROP_TEXTURE) && base >= 0) {
    // pow-2 mask/shift addressing (MT_tex, tracer.cpp:2297-2321)
    const int xm = ldt<SM>(Mi, 2), ym = ldt<SM>(Mi, 3), xs = ldt<SM>(Mi, 4);
    const float u = hb.hx - ldt<SM>(M, 12);
    const float v = hb.hy - ldt<SM>(M, 13);
    const int ix =
        __float2int_rz(floorf(u * (float)(xm + 1) / ldt<SM>(M, 10))) & xm;
    const int iy =
        __float2int_rz(floorf(v * (float)(ym + 1) / ldt<SM>(M, 11))) & ym;
    const int at = base + (iy << xs) + ix;
    if (texel) *texel = at;
    const int tx = ldi(T.tex_pk, at);
    mc[0] = ldf(T.tex_lut, (tx >> 16) & 255);
    mc[1] = ldf(T.tex_lut, (tx >> 8) & 255);
    mc[2] = ldf(T.tex_lut, tx & 255);
  }
  if (gamma_on && (props & PROP_GAMMA)) {
    // gamma decode x^2 (PAINT_COLX, tracer.cpp:664-673)
    for (int c = 0; c < 3; ++c) mc[c] = mc[c] * mc[c];
  }
  return props;
}

// ROUND: round 1 of two-round retirement that also writes the ray state
// (EMIT), or round 2 that resumes it (RESUME); whole traces (WHOLE) run
// whole_kernel. CULL: the warp's masks (cfg.cull non-zero) or every
// surface for every ray.
constexpr int WHOLE = 0, EMIT = 1, RESUME = 2;
constexpr int STATE_ROWS = 21;
constexpr int W_BLOCK = 128;   // threads a block of the Whitted modes

// The cooperative tail keeps each thread's loop state in shared memory,
// one column of TAIL_WORDS a thread (word k at col[k * W_BLOCK]): the
// ray (tmx aside), the throughput, the colour sums, depth and stack top.
constexpr int TAIL_WORDS = 22;

__device__ __forceinline__ void tail_save(float* col, const Ray& r,
                                          const float thr[3],
                                          const float acc[3], int depth,
                                          int sp) {
  const float v[TAIL_WORDS] = {
      r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmn, __int_as_float(r.osrf),
      __int_as_float(r.oside), __int_as_float(r.thru ? 1 : 0), r.olx, r.oly,
      r.olz, __int_as_float(r.orow), thr[0], thr[1], thr[2], acc[0], acc[1],
      acc[2], __int_as_float(depth), __int_as_float(sp)};
  for (int k = 0; k < TAIL_WORDS; ++k) col[k * W_BLOCK] = v[k];
}

__device__ __forceinline__ void tail_load(const float* col, Ray& r,
                                          float thr[3], float acc[3],
                                          int& depth, int& sp) {
  r.ox = col[0];
  r.oy = col[W_BLOCK];
  r.oz = col[2 * W_BLOCK];
  r.dx = col[3 * W_BLOCK];
  r.dy = col[4 * W_BLOCK];
  r.dz = col[5 * W_BLOCK];
  r.tmn = col[6 * W_BLOCK];
  r.osrf = __float_as_int(col[7 * W_BLOCK]);
  r.oside = __float_as_int(col[8 * W_BLOCK]);
  r.thru = __float_as_int(col[9 * W_BLOCK]) != 0;
  r.olx = col[10 * W_BLOCK];
  r.oly = col[11 * W_BLOCK];
  r.olz = col[12 * W_BLOCK];
  r.orow = __float_as_int(col[13 * W_BLOCK]);
  for (int c = 0; c < 3; ++c) thr[c] = col[(14 + c) * W_BLOCK];
  for (int c = 0; c < 3; ++c) acc[c] = col[(17 + c) * W_BLOCK];
  depth = __float_as_int(col[20 * W_BLOCK]);
  sp = __float_as_int(col[21 * W_BLOCK]);
}

// One segment of a ray, segment `it` of the thread at index i (the loop
// state r, thr, acc, depth, sp, stk, active): its nearest hit, its shadow
// rays, shading and the continuation, else the pop of a pending branch,
// else retirement (seg := it). TAIL: the cooperative tail, where every
// lane holds the ray of lane `owner`; the walks are dealt over the warp,
// and only the owner's branch stack is written (a pop is shuffled from
// it). RAY: segments that take each lane's own masks within the warp's
// where `per_ray`, if the warp's keeps more than cfg.own_min surfaces (the
// two-round modes, whole_kernel and paths_kernel, culled). EMIT_PATHS: the
// path-record kernel, which writes this segment's record to paths. SM:
// the tables in the block's shared memory. TAPE: the differentiable
// route's forward (tape_kernel), which writes the segment's tape words
// that the backward reads (ops/diff.py tape_read), each once: the flags
// word to ti[(it * words) * n + i]; where the segment hits, also the
// entry state (12 floats, still in r and thr when the hit is known) to
// tf[(it * TAPE_F + j) * n + i], the texel and the lights' bits (built in
// a register, a word of 32 lights at a time) to ti[(it * words + w) * n +
// i]; a miss leaves them unwritten. SCHLICK: Schlick's F (cfg.schlick, a
// template flag of the other modes' kernels, so that the exact Fresnel's
// instantiations keep their code; TAPE reads cfg.schlick at run time).
template <bool CAN_PUSH, bool EMIT_PATHS, bool CULL, bool TAIL,
          bool RAY = false, bool SM = false, bool TAPE = false,
          bool SCHLICK = false>
__device__ __forceinline__ void segment(
    const Tables& T, const Cfg& cfg, int it, int i, int n,
    int* __restrict__ paths, Ray& r, float thr[3], float acc[3], int& depth,
    int& sp, float (*stk)[SLOT], bool& active, int& seg, int owner,
    bool per_ray = false, float* __restrict__ tf = nullptr,
    int* __restrict__ ti = nullptr, int words = 0) {
  const bool own = RAY && per_ray;
  // the tape's flags word, texel and the lit lights' bits of the current
  // word of 32 (ops/diff.py FLAGS)
  unsigned tflags = TAPE ? T_ACTIVE : 0u;
  int texel = -1;
  unsigned lbits = 0u;
  const float amb[3] = {ldt<SM>(T.misc, 0), ldt<SM>(T.misc, 1),
                        ldt<SM>(T.misc, 2)};
  const bool gamma_on = ldt<SM>(T.misc, 3) > 0.0f;
  const bool fres_scene = ldt<SM>(T.misc, 4) > 0.0f;
  Hit hb;
  if (CULL) {
    const int* crow = nullptr;   // the cont row of this ray's last hit
    if ((cfg.cull & CULL_CONT) && active && r.orow >= 0)
      crow = T.cont + (size_t)r.orow * 2 * T.nw + (r.oside > 0 ? 0 : T.nw);
    const unsigned mine =
        warp_mask<false, TAIL, SM>(T, cfg.cull, active, r, crow);
    if (TAIL)   // every lane holds the owner's ray
      nearest_coop(T, r, mine, hb);
    else if (own && warp_kept(mine) > cfg.own_min)
      nearest_own<SM>(T, cfg.cull, r, active, mine, crow, hb);
    else
      nearest_masked<SM>(T, r, active, mine, hb);
  } else {
    nearest_all<true, SM>(T, r, hb);
  }
  // unculled, a lane in the loop has a ray
  const bool hit = (!CULL || active) && hb.t < BIG;
  bool cont = false;
  if (TAPE && hit) {
    tflags |= (unsigned)(hb.srf & T_SRF) | T_HIT |
              (hb.side > 0 ? T_SIDE : 0u) | (r.osrf == hb.srf ? T_OWN : 0u) |
              (hb.hm ? T_NUDGE : 0u);
    const float st[TAPE_F] = {r.ox,   r.oy,   r.oz,   r.dx,   r.dy,   r.dz,
                              thr[0], thr[1], thr[2], r.olx, r.oly, r.olz};
    for (int j = 0; j < TAPE_F; ++j)
      tf[((size_t)it * TAPE_F + j) * n + i] = st[j];
  }
  // path record (record_path, pallas_kernel.py:1871-1886): a miss keeps
  // side +1 and sets the bit of every active light (lit needs a hit)
  unsigned rec =
      EMIT_PATHS ? (1u << 12) | (((1u << T.nl) - 1u) << 16) : 0u;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  const float* M = T.mat_f;
  float mc[3] = {0.0f, 0.0f, 0.0f};
  float col[3] = {0.0f, 0.0f, 0.0f};
  int props = 0;
  float m_dff = 0.0f, m_spc = 0.0f, m_pow = 0.0f;
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  if (hit) {
    // normalize the normal
    const float nn = __frsqrt_rn(
        maxn(hb.nx * hb.nx + hb.ny * hb.ny + hb.nz * hb.nz, 1e-30f));
    nx = hb.nx * nn;
    ny = hb.ny * nn;
    nz = hb.nz * nn;
    rec = (unsigned)(hb.srf & 0xFFF) | (hb.side > 0 ? 1u << 12 : 0u) |
          (1u << 15);
    props = hit_material<SM>(T, hb, gamma_on, mc, M,
                             TAPE ? &texel : nullptr);
    m_dff = ldt<SM>(M, 3);
    m_spc = ldt<SM>(M, 4);
    m_pow = ldt<SM>(M, 5);
    for (int c = 0; c < 3; ++c) col[c] = mc[c] * amb[c];
  }
  // culled, every lane takes part in every light's shadow pass
  const int nl = CULL || hit ? T.nl : 0;
  for (int l = 0; l < nl; ++l) {
    if (TAPE && l > 0 && (l & 31) == 0) {   // lights l - 32 .. l - 1 done
      ti[((size_t)it * words + 1 + l / 32) * n + i] = (int)lbits;
      lbits = 0u;
    }
    const float* L = T.lg_f + (size_t)l * LF;
    const unsigned unlit = EMIT_PATHS ? 1u << (16 + l) : 0u;
    Ray sr;
    sr.ox = hb.wx; sr.oy = hb.wy; sr.oz = hb.wz;
    sr.dx = sr.dy = sr.dz = 0.0f;
    sr.tmn = 0.0f;
    sr.tmx = 1.0f;
    sr.osrf = hb.srf;
    sr.oside = hb.side;
    sr.thru = false;
    sr.olx = hb.hx; sr.oly = hb.hy; sr.olz = hb.hz;
    sr.orow = -1;
    float r_dot = 0.0f;
    bool need = false;
    if (hit) {
      sr.dx = ldt<SM>(L, 0) - hb.wx;
      sr.dy = ldt<SM>(L, 1) - hb.wy;
      sr.dz = ldt<SM>(L, 2) - hb.wz;
      r_dot = sr.dx * nx + sr.dy * ny + sr.dz * nz;
      need = r_dot > 0.0f;
      if (!need) rec |= unlit;
    }
    bool occ;
    if (CULL) {
      const int* srow = nullptr;   // the receiver's lsort row for light l
      if ((cfg.cull & CULL_LSORT) && need)
        srow = T.shad + (size_t)hb.row * T.nl * T.nw + (size_t)l * T.nw;
      const unsigned mine =
          warp_mask<true, TAIL, SM>(T, cfg.cull, need, sr, srow);
      occ = TAIL ? occluded_coop(T, sr, mine)
            : own && warp_kept(mine) > cfg.own_min
                ? occluded_own<SM>(T, cfg.cull, sr, need, mine, srow)
                : occluded_masked<SM>(T, sr, need, mine);
    } else {
      occ = need && occluded_all<SM>(T, sr);
    }
    if (!need) continue;
    if (occ) {
      rec |= unlit;
      continue;
    }
    if (TAPE) lbits |= 1u << (l & 31);
    // lit and unshadowed: attenuated diffuse + specular
    const float lvx = sr.dx, lvy = sr.dy, lvz = sr.dz;
    const float r2 = lvx * lvx + lvy * lvy + lvz * lvz;
    const float rr = __fsqrt_rn(maxn(r2, 1e-30f));
    const float attn = __frsqrt_rn(
        maxn(ldt<SM>(L, 6) + ldt<SM>(L, 7) * rr + ldt<SM>(L, 8) * r2,
             1e-30f));
    const float dfs =
        (props & PROP_DIFFUSE) ? r_dot / rr * attn * m_dff : 0.0f;
    float spc = 0.0f;
    if (props & PROP_SPECULAR) {
      const float rlx = lvx - 2.0f * r_dot * nx;
      const float rly = lvy - 2.0f * r_dot * ny;
      const float rlz = lvz - 2.0f * r_dot * nz;
      const float sdot = rlx * dx + rly * dy + rlz * dz;
      if (sdot > 0.0f) {
        const float d2 = dx * dx + dy * dy + dz * dz;
        float cosr = sdot * __frsqrt_rn(maxn(d2 * r2, 1e-30f));
        cosr = clampn(cosr, 1e-6f, 1.0f);
        spc = expf(m_pow * logf(cosr)) * m_spc;
      }
    }
    for (int c = 0; c < 3; ++c) {
      const float lc = ldt<SM>(L, 3 + c);
      col[c] = col[c] + ((props & PROP_METAL)
                             ? mc[c] * lc * (dfs + spc)
                             : mc[c] * lc * dfs + lc * spc);
    }
  }
  if (hit) {
    if (props & PROP_LIGHT) {
      for (int c = 0; c < 3; ++c) col[c] = mc[c];
    }

    const Fresnel fr = fresnel<SM>(props, M, fres_scene, dx, dy, dz, nx,
                                   ny, nz, TAPE ? cfg.schlick != 0 : SCHLICK);

    // local weight from the ORIGINAL material rfl/trn (TR_mix,
    // tracer.cpp:3566-3571), not the Fresnel-modulated values
    const float m_rfl = ldt<SM>(M, 6), m_trn = ldt<SM>(M, 7);
    const float lw = maxn(1.0f - m_trn - m_rfl, 0.0f);
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + thr[c] * col[c] * lw;

    // continuations
    const bool deep_ok = depth < cfg.depth;
    float trl[3], trn[3];
    for (int c = 0; c < 3; ++c) {
      trl[c] = thr[c] * fr.c_rfl;
      trn[c] = thr[c] * fr.c_trn;
    }
    const bool go_rfl =
        deep_ok && maxn(maxn(trl[0], trl[1]), trl[2]) > cfg.cutoff;
    const bool go_trn =
        deep_ok && maxn(maxn(trn[0], trn[1]), trn[2]) > cfg.cutoff;
    cont = go_rfl || go_trn;
    if (cont) rec |= (go_rfl ? 1u : 2u) << 13;
    if (TAPE && cont) tflags |= (go_rfl ? 1u : 2u) << T_KIND_SHIFT;
    if (CAN_PUSH && go_rfl && go_trn && sp < cfg.stack) {
      if (TAPE) tflags |= T_PUSH | (((unsigned)sp & 15u) << T_SLOT_SHIFT);
      // push the refraction branch (the tail: on the owner's stack)
      if (!TAIL || (int)(threadIdx.x & 31u) == owner) {
        float* slot = stk[sp];
        slot[0] = hb.wx; slot[1] = hb.wy; slot[2] = hb.wz;
        slot[3] = fr.rfx; slot[4] = fr.rfy; slot[5] = fr.rfz;
        slot[6] = trn[0]; slot[7] = trn[1]; slot[8] = trn[2];
        slot[9] = __int_as_float(depth + 1);
        slot[10] = __int_as_float(hb.srf);
        slot[11] = __int_as_float(hb.side);
        slot[12] = hb.hx; slot[13] = hb.hy; slot[14] = hb.hz;
      }
      ++sp;
    }
    if (cont) {
      // continue with the reflection if live, else the refraction
      if (go_rfl) {
        const float ddn = dx * nx + dy * ny + dz * nz;
        r.dx = dx - 2.0f * ddn * nx;
        r.dy = dy - 2.0f * ddn * ny;
        r.dz = dz - 2.0f * ddn * nz;
      } else {
        r.dx = fr.rfx; r.dy = fr.rfy; r.dz = fr.rfz;
      }
      for (int c = 0; c < 3; ++c) thr[c] = go_rfl ? trl[c] : trn[c];
      r.ox = hb.wx; r.oy = hb.wy; r.oz = hb.wz;
      depth = depth + 1;
      r.osrf = hb.srf;
      r.oside = hb.side;
      r.thru = !go_rfl;
      r.tmn = 0.0f;
      r.olx = hb.hx; r.oly = hb.hy; r.olz = hb.hz;
      if (CULL) r.orow = hb.row;
    }
  }
  if (CULL && !active) return;
  if (EMIT_PATHS) paths[(size_t)it * n + i] = (int)rec;
  if (TAPE) {
    if (!cont && CAN_PUSH && sp > 0)
      tflags |= T_POP | (((unsigned)(sp - 1) & 15u) << T_SLOT_SHIFT);
    ti[((size_t)it * words) * n + i] = (int)tflags;
    if (hit) {
      ti[((size_t)it * words + 1) * n + i] = texel;
      // the light loop's last word, then the words of no active light
      for (int w = 2 + (nl > 0 ? (nl - 1) / 32 : 0); w < words; ++w) {
        ti[((size_t)it * words + w) * n + i] = (int)lbits;
        lbits = 0u;
      }
    }
  }
  if (!cont) {
    if (!CAN_PUSH || sp == 0) {   // retired
      active = false;
      seg = it;
      return;
    }
    // pop a pending refraction branch (the tail: the owner's, shuffled
    // to every lane)
    --sp;
    float slot[SLOT];
    for (int k = 0; k < SLOT; ++k)
      slot[k] = TAIL ? __shfl_sync(FULL_WARP, stk[sp][k], owner)
                     : stk[sp][k];
    r.ox = slot[0]; r.oy = slot[1]; r.oz = slot[2];
    r.dx = slot[3]; r.dy = slot[4]; r.dz = slot[5];
    thr[0] = slot[6]; thr[1] = slot[7]; thr[2] = slot[8];
    depth = __float_as_int(slot[9]);
    r.osrf = __float_as_int(slot[10]);
    r.oside = __float_as_int(slot[11]);
    r.olx = slot[12]; r.oly = slot[13]; r.olz = slot[14];
    r.thru = true;
    r.tmn = 0.0f;
    r.orow = -1;
  }
}

// The cooperative tail of a culled whole-trace warp (file header), from
// segment it0: the rays of the lanes of `live`, one after another in
// ascending lane order, each to its end, every lane running its segments.
// Each lane's state is in its column of the warp's shared columns `cols`
// (tail_save); a ray's colour sums go back to its column. Not inlined: the
// warp calls it once, and the per-lane loop keeps its registers. stk: the
// lane's own branch stack (local memory), whose owner's slots the pop
// shuffles to every lane; DEEP, lane 0's in the device-memory scratch,
// each lane's d = min(stack, max_segments) slots after the lane before's,
// and every lane takes the owner's (the same address on every lane, so
// the shuffle moves the value each lane already read).
template <bool CAN_PUSH, bool DEEP, bool SCHLICK>
__device__ __noinline__ void coop_tail(Tables T, Cfg cfg, float* cols,
                                       unsigned live, int it0,
                                       float (*stk)[SLOT]) {
  const int lane = (int)(threadIdx.x & 31u);
  const int d = cfg.stack < cfg.max_segments ? cfg.stack : cfg.max_segments;
  for (; live; live &= live - 1u) {
    const int owner = __ffs(live) - 1;
    float (*const ostk)[SLOT] = DEEP ? stk + (size_t)owner * d : stk;
    Ray r;
    float thr[3], acc[3];
    int depth, sp, seg;
    tail_load(cols + owner, r, thr, acc, depth, sp);
    r.tmx = BIG;
    bool active = true;
    for (int it = it0; it < cfg.max_segments && active; ++it)
      segment<CAN_PUSH, false, true, true, false, false, false, SCHLICK>(
          T, cfg, it, 0, 0, nullptr, r, thr, acc, depth, sp, ostk, active,
          seg, owner);
    if (lane == owner)
      for (int c = 0; c < 3; ++c) cols[owner + (17 + c) * W_BLOCK] = acc[c];
  }
}

// The differentiable route's forward for ray i (tape_kernel; ops/diff.py
// forward_kernel, whose plain version forward_plain is the plain tracer's
// bounce with a tape): unculled (a parameter update moves surfaces away
// from the bounding spheres compile_scene made), every segment through
// segment<> with TAPE, so the colours are whole_kernel's (trace_rays's) bit
// for bit; the segments after the one it retired in record a zero flags
// word, and nothing else (the tape's contract, ops/diff.py tape_read).
// The branch stack: CAP slots in local memory (a ray pushes at most once a
// segment, so min(stack, max_segments) <= CAP slots are ever held), or,
// CAP 0, the ray's d slots of the device-memory scratch deep (n, d, SLOT).
template <int CAP>
__device__ __forceinline__ void tape_ray(const float* __restrict__ rays,
                                         float* __restrict__ out,
                                         float* __restrict__ tf,
                                         int* __restrict__ ti, int n,
                                         int words, const Tables& T,
                                         const Cfg& cfg, int i,
                                         float* __restrict__ deep = nullptr,
                                         int d = 0) {
  Ray r;
  r.ox = rays[i];
  r.oy = rays[n + i];
  r.oz = rays[2 * n + i];
  r.dx = rays[3 * n + i];
  r.dy = rays[4 * n + i];
  r.dz = rays[5 * n + i];
  r.tmn = rays[6 * n + i];
  r.tmx = BIG;
  r.osrf = -1;
  r.oside = 1;
  r.thru = false;
  r.olx = r.oly = r.olz = 0.0f;
  r.orow = -1;
  float thr[3] = {1.0f, 1.0f, 1.0f};
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int depth = 0, sp = 0, seg = cfg.max_segments;
  float local[CAP > 0 ? CAP : 1][SLOT];
  float (*stk)[SLOT] =
      CAP > 0 ? local
              : reinterpret_cast<float (*)[SLOT]>(deep + (size_t)i * d * SLOT);
  bool active = true;
  int it = 0;
  for (; it < cfg.max_segments && active; ++it)
    segment<true, false, false, false, false, false, true>(
        T, cfg, it, i, n, nullptr, r, thr, acc, depth, sp, stk, active, seg,
        0, false, tf, ti, words);
  for (; it < cfg.max_segments; ++it) ti[((size_t)it * words) * n + i] = 0;
  out[i] = acc[0];
  out[n + i] = acc[1];
  out[2 * n + i] = acc[2];
}

// The two rounds of two-round retirement (file header), single-branch
// scenes only: one thread a ray, a grid of ceil(n / W_BLOCK) blocks.
template <int ROUND, bool CULL, bool OWN, bool SCHLICK>
__global__ void __launch_bounds__(W_BLOCK)
whitted_kernel(const float* __restrict__ rays, float* __restrict__ out,
               float* __restrict__ state, const int* __restrict__ idx,
               const int* __restrict__ count, int n, Tables T, Cfg cfg) {
  static_assert(ROUND == EMIT || ROUND == RESUME,
                "whole traces run whole_kernel");
  // OWN, per-ray masks (culled): EMIT's segments after the camera
  // segment, every segment of RESUME's dense mode
  static_assert(!CULL || ROUND != RESUME || OWN, "RESUME's dense mode");
  constexpr bool RAY = CULL && OWN;
  // culled, every lane of a warp runs the segment loop, with a ray or
  // without one (active false): the warp collectives need the whole warp
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool active = i < n;
  if (ROUND == RESUME) {
    // the dense mode: more than cfg.sw (warp_max) survivors, else
    // resume_sparse runs them
    const int cnt = *count;
    if (cnt <= cfg.sw) return;
    active = active && i < cnt;
    if (active) i = idx[i];
  }
  if (!CULL && !active) return;   // unculled, a lane is on its own
  const bool has_ray = active;
  Ray r;
  r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = r.tmn = 0.0f;
  r.osrf = -1;
  r.oside = 1;
  r.thru = false;
  r.olx = r.oly = r.olz = 0.0f;
  r.orow = -1;   // also after a resume: the state holds no table row
  float thr[3] = {1.0f, 1.0f, 1.0f};
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int depth = 0, sp = 0;
  if (has_ray && ROUND == RESUME) {
    const float* s = state + i;
    r.ox = s[0];
    r.oy = s[(size_t)n];
    r.oz = s[2 * (size_t)n];
    r.dx = s[3 * (size_t)n];
    r.dy = s[4 * (size_t)n];
    r.dz = s[5 * (size_t)n];
    r.tmn = s[6 * (size_t)n];
    for (int c = 0; c < 3; ++c) thr[c] = s[(7 + c) * (size_t)n];
    depth = __float_as_int(s[10 * (size_t)n]);
    r.osrf = __float_as_int(s[11 * (size_t)n]);
    r.oside = __float_as_int(s[12 * (size_t)n]);
    r.thru = __float_as_int(s[13 * (size_t)n]) != 0;
    r.olx = s[14 * (size_t)n];
    r.oly = s[15 * (size_t)n];
    r.olz = s[16 * (size_t)n];
    for (int c = 0; c < 3; ++c) acc[c] = s[(18 + c) * (size_t)n];
  } else if (has_ray) {
    r.ox = rays[i];
    r.oy = rays[n + i];
    r.oz = rays[2 * n + i];
    r.dx = rays[3 * n + i];
    r.dy = rays[4 * n + i];
    r.dz = rays[5 * n + i];
    r.tmn = rays[6 * n + i];
  }
  r.tmx = BIG;
  float stk[1][SLOT];   // no branch stack: never read

  // The TPU kernel caps segments per block; here the cap is per thread.
  // That is equivalent because a retired lane is a fixed point of
  // shade_and_continue (pallas_kernel.py:1697-1994): with active = 0 its
  // hit is masked off, so acc gets no contribution, cont and can_pop are
  // false, the stack is neither pushed nor popped, and active stays 0.
  // A lane still active at block iteration `it` has run exactly `it`
  // segments, so stopping each thread at max_segments is exact.
  int seg = cfg.max_segments;   // the segment this thread retired in
  for (int it = 0; it < cfg.max_segments; ++it) {
    const bool per_ray = RAY && (ROUND == RESUME || it > 0);
    if (CULL ? !__any_sync(FULL_WARP, active) : !active) break;
    segment<false, false, CULL, false, RAY, false, false, SCHLICK>(
        T, cfg, it, i, n, nullptr, r, thr, acc, depth, sp, stk, active, seg,
        0, per_ray);
  }
  if (!has_ray) return;
  out[i] = acc[0];
  out[n + i] = acc[1];
  out[2 * n + i] = acc[2];
  if (ROUND == EMIT) {
    // a thread that retired left the loop before the cap: its ray is as
    // it was, with thru and active 0 (pallas_kernel.py:1935, 1937)
    const bool alive = seg == cfg.max_segments;
    const float vals[STATE_ROWS] = {
        r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmn, thr[0], thr[1], thr[2],
        __int_as_float(depth), __int_as_float(r.osrf),
        __int_as_float(r.oside), __int_as_float(alive && r.thru ? 1 : 0),
        r.olx, r.oly, r.olz, __int_as_float(alive ? 1 : 0),
        acc[0], acc[1], acc[2]};
    for (int k = 0; k < STATE_ROWS; ++k) state[(size_t)k * n + i] = vals[k];
  }
}

// RESUME's sparse mode (file header): when at most cfg.sw (warp_max) rays
// survive round 1, warp g (grid-stride over warps) runs ray idx[g] for g <
// *count on all 32 lanes, segment by segment in step, as coop_tail runs a
// ray: every lane loads the ray's state (the same addresses, one
// transaction), the masks are one-ray bundles without collectives, the
// kept surfaces and blockers are dealt out by rank and the nearest hit is
// reduced by the butterfly on (t, original id), so the chain is the
// per-lane walk's bit for bit. The ray has no continuation row for its
// first resumed segment (orow -1), as in the dense mode. Lane 0 writes its
// colours. With cfg.cull 0 the masks keep every real surface (and every
// blocker), dealt out the same way. Single-branch scenes: no stack.
template <bool SCHLICK>
__global__ void __launch_bounds__(W_BLOCK)
resume_sparse(const float* __restrict__ state, const int* __restrict__ idx,
              const int* __restrict__ count, float* __restrict__ out, int n,
              Tables T, Cfg cfg) {
  const int cnt = *count;
  if (cnt > cfg.sw) return;   // the dense mode runs them
  const int lane = (int)(threadIdx.x & 31u);
  const int warps = (int)(gridDim.x * (blockDim.x >> 5));
  float stk[1][SLOT];
  for (int g = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5); g < cnt;
       g += warps) {
    const int i = idx[g];
    const float* st = state + i;
    Ray r;
    r.ox = st[0];
    r.oy = st[(size_t)n];
    r.oz = st[2 * (size_t)n];
    r.dx = st[3 * (size_t)n];
    r.dy = st[4 * (size_t)n];
    r.dz = st[5 * (size_t)n];
    r.tmn = st[6 * (size_t)n];
    r.tmx = BIG;
    float thr[3], acc[3];
    for (int c = 0; c < 3; ++c) thr[c] = st[(7 + c) * (size_t)n];
    int depth = __float_as_int(st[10 * (size_t)n]);
    r.osrf = __float_as_int(st[11 * (size_t)n]);
    r.oside = __float_as_int(st[12 * (size_t)n]);
    r.thru = __float_as_int(st[13 * (size_t)n]) != 0;
    r.olx = st[14 * (size_t)n];
    r.oly = st[15 * (size_t)n];
    r.olz = st[16 * (size_t)n];
    r.orow = -1;
    for (int c = 0; c < 3; ++c) acc[c] = st[(18 + c) * (size_t)n];
    int sp = 0, seg;
    bool active = true;
    for (int it = 0; it < cfg.max_segments && active; ++it)
      segment<false, false, true, true, false, false, false, SCHLICK>(
          T, cfg, it, 0, 0, nullptr, r, thr, acc, depth, sp, stk, active,
          seg, 0);
    if (lane == 0) {
      out[i] = acc[0];
      out[n + i] = acc[1];
      out[2 * n + i] = acc[2];
    }
  }
}

// ---- the path-record kernel (whitted_paths_launch; file header) ---------

constexpr int P_BLOCK = 256;   // threads a block
// the most dynamic shared memory a block stages its tables in: two such
// blocks and their 1 KB reserves fit in an SM's 228 KB, so the copies keep
// the number of blocks an SM that the registers allow (ops/cuda_kernel.py
// PATHS_SMEM_BYTES mirrors it)
constexpr int PATHS_SMEM = 112 * 1024;
// the tables a block stages, in this order: sp_f, sp_i, cl_f, mat_f,
// mat_i, lg_f, misc
constexpr int P_TABLES = 7;

// A block's plan for its dynamic shared memory: the mbarrier at byte 0,
// table k at off[k] (a multiple of 16) with bytes[k] bytes (cl_f 0: it
// stays in device memory, where the others fit and it does not), total
// the bytes a block takes (ops/cuda_kernel.py paths_staging mirrors it)
struct Staging {
  int off[P_TABLES], bytes[P_TABLES];
  int total;
};

// Copies the block's tables into its shared memory at base (plan st): one
// bulk asynchronous copy a table (cp.async.bulk, Hopper's 1-D TMA path;
// thread 0 issues them and they complete on the mbarrier at base) of its
// bytes rounded down to 16, and the rest, at most three words, by plain
// loads; returns the tables pointing at the copies. Every thread of the
// block calls it once.
__device__ __forceinline__ Tables stage_tables(Tables T, const Staging& st,
                                               unsigned char* base) {
  const void* src[P_TABLES] = {T.sp_f,  T.sp_i, T.cl_f, T.mat_f,
                               T.mat_i, T.lg_f, T.misc};
  const unsigned bar = (unsigned)__cvta_generic_to_shared(base);
  if (threadIdx.x == 0) {
    unsigned tx = 0;
    for (int k = 0; k < P_TABLES; ++k) tx += (unsigned)st.bytes[k] & ~15u;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(tx) : "memory");
    for (int k = 0; k < P_TABLES; ++k) {
      const unsigned bulk = (unsigned)st.bytes[k] & ~15u;
      if (bulk)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];"
            :: "r"(bar + (unsigned)st.off[k]), "l"(src[k]), "r"(bulk),
               "r"(bar)
            : "memory");
    }
  }
  // word w of table k's last bytes % 16, by thread 4k + w
  if (threadIdx.x < 4 * P_TABLES) {
    const int k = (int)threadIdx.x >> 2, w = (int)threadIdx.x & 3;
    const int bulk = st.bytes[k] & ~15;
    if (bulk + 4 * w < st.bytes[k])
      reinterpret_cast<int*>(base + st.off[k] + bulk)[w] =
          reinterpret_cast<const int*>(static_cast<const char*>(src[k]) +
                                       bulk)[w];
  }
  __syncthreads();   // the barrier's init and those words, to every thread
  for (unsigned done = 0; !done;)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1],"
        " 0; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar) : "memory");
  T.sp_f = reinterpret_cast<const float*>(base + st.off[0]);
  T.sp_i = reinterpret_cast<const int*>(base + st.off[1]);
  if (st.bytes[2]) T.cl_f = reinterpret_cast<const float*>(base + st.off[2]);
  T.mat_f = reinterpret_cast<const float*>(base + st.off[3]);
  T.mat_i = reinterpret_cast<const int*>(base + st.off[4]);
  T.lg_f = reinterpret_cast<const float*>(base + st.off[5]);
  T.misc = reinterpret_cast<const float*>(base + st.off[6]);
  return T;
}

// the first of the next 32 rays, for the whole warp: one atomicAdd on the
// work queue by lane 0
__device__ __forceinline__ int next_rays(int* queue) {
  int base = 0;
  if ((threadIdx.x & 31u) == 0) base = atomicAdd(queue, 32);
  return __shfl_sync(FULL_WARP, base, 0);
}

// The path records of rays 0..n-1 (file header), segments capped at
// cfg.max_segments, on a persistent grid: each warp takes the next 32
// consecutive rays from the work queue *queue, traces them as the
// Whitted modes trace a ray (segment<>, no branch stack), writes their
// colours and records, and takes the next 32 until the queue is empty.
// SM: the block first copies its tables into shared memory
// (stage_tables). CULL: the warp's masks; OWN (culled), each lane's own
// within them after the camera segment (nearest_own, occluded_own, where
// the warp's keeps more than cfg.own_min surfaces), as EMIT does;
// unculled, each lane walks every surface and leaves the loop once its
// ray retires. The blocks an SM must hold at once, to which
// __launch_bounds__ holds the registers: culled two (128 a thread);
// unculled in device memory three (80, so that 24 warps hide the
// device-memory reads); unculled in shared memory no minimum (ptxas
// takes 127: two blocks). Each was the fastest on the H100 (PERF.md,
// section 6).
template <bool CULL, bool SM, bool OWN, bool SCHLICK>
__global__ void __launch_bounds__(P_BLOCK, CULL ? 2 : SM ? 1 : 3)
paths_kernel(const float* __restrict__ rays, float* __restrict__ out,
             int* __restrict__ paths, int n, Tables T, Cfg cfg, Staging st,
             int* __restrict__ queue) {
  static_assert(CULL || !OWN, "per-ray masks refine the warp's masks");
  extern __shared__ __align__(16) unsigned char p_tables[];
  if (SM) T = stage_tables(T, st, p_tables);
  float stk[1][SLOT];   // no branch stack: never read
  for (int base = next_rays(queue); base < n; base = next_rays(queue)) {
    const int i = base + (int)(threadIdx.x & 31u);
    bool active = i < n;
    Ray r;
    r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = r.tmn = 0.0f;
    if (active) {
      r.ox = rays[i];
      r.oy = rays[n + i];
      r.oz = rays[2 * n + i];
      r.dx = rays[3 * n + i];
      r.dy = rays[4 * n + i];
      r.dz = rays[5 * n + i];
      r.tmn = rays[6 * n + i];
    }
    r.tmx = BIG;
    r.osrf = -1;
    r.oside = 1;
    r.thru = false;
    r.olx = r.oly = r.olz = 0.0f;
    r.orow = -1;
    float thr[3] = {1.0f, 1.0f, 1.0f};
    float acc[3] = {0.0f, 0.0f, 0.0f};
    int depth = 0, sp = 0;
    int seg = cfg.max_segments;   // the segment this ray retired in
    // culled, every lane of the warp runs the loop while any has a ray
    for (int it = 0; it < cfg.max_segments; ++it) {
      if (CULL ? !__any_sync(FULL_WARP, active) : !active) break;
      segment<false, true, CULL, false, OWN, SM, false, SCHLICK>(
          T, cfg, it, i, n, paths, r, thr, acc, depth, sp, stk, active, seg,
          0, OWN && it > 0);
    }
    if (i < n) {
      out[i] = acc[0];
      out[n + i] = acc[1];
      out[2 * n + i] = acc[2];
      // the segments after the one this ray retired in record 0
      for (int k = seg + 1; k < cfg.max_segments; ++k)
        paths[(size_t)k * n + i] = 0;
    }
  }
}

// ---- the whole-trace kernel (whitted_launch; file header) ---------------

// The Whitted colours of rays 0..n-1 (file header): thread i traces ray i
// to its end (segment<>, the branch stack where CAN_PUSH) on a grid of
// ceil(n / W_BLOCK) blocks, the tables in device memory. Culled, the
// warp's masks, and once at most cfg.sw (coop_max) of the warp's lanes
// hold a ray the cooperative tail runs them one at a time (coop_tail);
// OWN, each lane's own masks within the warp's after the camera segment
// where the warp's keeps more than cfg.own_min surfaces, as EMIT does.
// Culled, four blocks an SM (128 registers a thread): without the minimum
// ptxas took 154-168 registers (three blocks), which lost; unculled, five
// (96 registers): without it ptxas took 104-107 (four blocks), 5-10%
// slower. The branch stack (CAN_PUSH): MAX_STACK slots in local memory,
// or, DEEP (min(stack, max_segments) > MAX_STACK), the ray's d slots of
// the device-memory scratch deep (n, d, SLOT) the caller allocates (a ray
// pushes at most once a segment, so it holds at most d). SCHLICK:
// Schlick's F.
template <bool CAN_PUSH, bool CULL, bool OWN, bool DEEP, bool SCHLICK>
__global__ void __launch_bounds__(W_BLOCK, CULL ? 4 : 5)
whole_kernel(const float* __restrict__ rays, float* __restrict__ out, int n,
             Tables T, Cfg cfg, float* __restrict__ deep) {
  static_assert(CULL || !OWN, "per-ray masks refine the warp's masks");
  static_assert(CAN_PUSH || !DEEP, "a deep stack holds pushed branches");
  // culled, every lane of a warp runs the segment loop, with a ray or
  // without one (active false): the warp collectives need the whole warp
  const int i = blockIdx.x * W_BLOCK + threadIdx.x;
  bool active = i < n;
  if (!CULL && !active) return;   // unculled, a lane is on its own
  Ray r;
  r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = r.tmn = 0.0f;
  if (active) {
    r.ox = rays[i];
    r.oy = rays[n + i];
    r.oz = rays[2 * n + i];
    r.dx = rays[3 * n + i];
    r.dy = rays[4 * n + i];
    r.dz = rays[5 * n + i];
    r.tmn = rays[6 * n + i];
  }
  r.tmx = BIG;
  r.osrf = -1;
  r.oside = 1;
  r.thru = false;
  r.olx = r.oly = r.olz = 0.0f;
  r.orow = -1;
  float thr[3] = {1.0f, 1.0f, 1.0f};
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int depth = 0, sp = 0;
  float local[CAN_PUSH && !DEEP ? MAX_STACK : 1][SLOT];
  const int d = cfg.stack < cfg.max_segments ? cfg.stack : cfg.max_segments;
  // (a padding lane of a culled warp, i >= n, never pushes nor pops)
  float (*stk)[SLOT] =
      DEEP ? reinterpret_cast<float (*)[SLOT]>(deep + (size_t)i * d * SLOT)
           : local;
  int seg = cfg.max_segments;   // the segment this ray retired in
  // the cooperative tail's columns: once at most cfg.sw of the warp's
  // lanes hold a ray, each lane saves its state in its column and the warp
  // runs those rays one at a time; then each lane takes back its sums
  __shared__ float tail[CULL ? TAIL_WORDS * W_BLOCK : 1];
  for (int it = 0; it < cfg.max_segments; ++it) {
    if (CULL) {
      const unsigned live = __ballot_sync(FULL_WARP, active);
      if (!live) break;
      if (__popc(live) <= cfg.sw) {
        float* const cols = tail + (threadIdx.x & ~31u);
        const int lane = (int)(threadIdx.x & 31u);
        tail_save(cols + lane, r, thr, acc, depth, sp);
        __syncwarp();
        coop_tail<CAN_PUSH, DEEP, SCHLICK>(
            T, cfg, cols, live, it, DEEP ? stk - (size_t)lane * d : stk);
        __syncwarp();
        for (int c = 0; c < 3; ++c) acc[c] = cols[lane + (17 + c) * W_BLOCK];
        break;
      }
    } else if (!active) {
      break;
    }
    segment<CAN_PUSH, false, CULL, false, OWN, false, false, SCHLICK>(
        T, cfg, it, i, n, nullptr, r, thr, acc, depth, sp, stk, active, seg,
        0, OWN && it > 0);
  }
  if (i >= n) return;
  out[i] = acc[0];
  out[n + i] = acc[1];
  out[2 * n + i] = acc[2];
}

// The differentiable route's forward: a thread a ray (tape_ray<CAP>).
template <int CAP>
__global__ void __launch_bounds__(W_BLOCK)
tape_kernel(const float* __restrict__ rays, float* __restrict__ out,
            float* __restrict__ tf, int* __restrict__ ti, int n, int words,
            Tables T, Cfg cfg, float* __restrict__ deep, int d) {
  const int i = blockIdx.x * W_BLOCK + threadIdx.x;
  if (i < n) tape_ray<CAP>(rays, out, tf, ti, n, words, T, cfg, i, deep, d);
}

// ---- path tracing (PT mode) -------------------------------------------

constexpr int PT_SHALLOW = 2;   // levels where both Fresnel branches go on
constexpr int PT_STACK = 6;     // pending-sibling slots per thread
// words per slot: origin 3, direction 3, throughput 3, and one word that
// packs the depth (bits 0-9), side > 0 (bit 10), thru (bit 11) and the
// surface's original id (bits 12-31)
constexpr int PT_SLOT = 10;
constexpr int PT_MAX_DEPTH = (1 << 10) - 1;
constexpr int PT_BLOCK = 128;   // threads a block
// every thread's stack in dynamic shared memory: under the 48 KB a launch
// may ask for without cudaFuncSetAttribute
constexpr size_t PT_SMEM = sizeof(float) * PT_STACK * PT_SLOT * PT_BLOCK;
static_assert(PT_SMEM <= 48 * 1024, "PT stack above 48 KB a block");
constexpr unsigned LCG_A = 214013u, LCG_C = 2531011u;

// one LCG draw (tracer.h:48-53): the top 24 bits over 2^24, exact in f32
__device__ __forceinline__ float lcg_uniform(unsigned& s) {
  s = s * LCG_A + LCG_C;
  return (float)(s >> 8) * (1.0f / 16777216.0f);
}

// ---- culling in PT mode ----------------------------------------------------
//
// The TPU kernel keeps its reach bounds in PT mode (cull_on without the
// lsort and cont masks, pallas_kernel.py:524-539: PT has no shadow pass,
// and a sibling popped from the stack does not come from the previous
// hit). Here a persistent warp holds nodes of unrelated samples at
// different depths, most of them cosine-hemisphere bounces, so a bundle
// of the warp's rays spans nearly every direction, and the union of its
// lanes' masks keeps several times what each lane needs (PERF.md §6). So
// each lane culls for its own ray alone: per word of 32 surfaces it tests
// its ray against their bounding spheres (ray_reaches: about 20 FP32
// operations a sphere, against a surface test's 48-112) and walks the
// bits it kept, apart from the other lanes. No collective, so the loop's
// structure is the unculled kernel's.

// this lane's reach bits of the spheres 32w .. 32w+31
__device__ __forceinline__ unsigned ray_word(const Tables& T, const Ray& r,
                                             float dhx, float dhy, float dhz,
                                             int w) {
  const int end = min(32, T.ns - 32 * w);
  unsigned m = 0u;
  for (int b = 0; b < end; ++b)
    if (ray_reaches(T, r, dhx, dhy, dhz, 32 * w + b)) m |= 1u << b;
  return m;
}

// the nearest hit of a culled PT node over the surfaces its own ray may
// reach, in ascending row order word by word (continuations from the
// world hit point: LOCAL false)
__device__ void nearest_reach(const Tables& T, const Ray& r, Hit& best) {
  no_hit(best);
  const float il =
      __frsqrt_rn(maxn(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-30f));
  const float dhx = r.dx * il, dhy = r.dy * il, dhz = r.dz * il;
  const int words = (T.ns + 31) >> 5;
  for (int w = 0; w < words; ++w) {
    unsigned word = ray_word(T, r, dhx, dhy, dhz, w);
    while (word) {
      const int s = w * 32 + __ffs(word) - 1;
      word &= word - 1u;
      surface<false, false>(T, s, r, best);
    }
  }
}

// Path-traced samples 0..n-1: the split-tree walk of ops/pt.py trace_pt
// (pt_body/pt_cond, pallas_kernel.py:1365-1669), pulled from the work
// queue *queue by a persistent grid. Each node draws u1 u2 (hemisphere),
// u_rr (roulette), u_split (Fresnel choice) in that order, gathers the
// hit's emission, and continues with the diffuse child, else the
// transmission, else the reflection, pushing the siblings it does not
// take (reflection first, so the transmission pops first). A sample
// retires when it has no node left or after 6*(depth+1) nodes, and writes
// its radiance. At the top of every iteration the lanes without a sample
// take the next ones with one atomicAdd for the warp, ranked by lane, so
// a warp's first fetch is 32 consecutive samples; a lane that finds the
// queue empty is done, and the warp leaves when none of its lanes has a
// sample. The largest node count of the warp's samples goes into *iters
// with one atomicMax, the call's count M that the seed tail needs.
// Continuations take their origin from the world hit point (LOCAL
// false), as the jnp tracer does. CULL: each node walks the surfaces its
// ray may reach (nearest_reach); else every surface (nearest_all).
template <bool CULL>
__global__ void __launch_bounds__(PT_BLOCK)
pt_kernel(const float* __restrict__ rays, const int* __restrict__ seeds,
          float* __restrict__ out, int n, Tables T, int depth,
          int* __restrict__ iters, int* __restrict__ queue) {
  // word v of slot s of this thread's stack is stk[(s * PT_SLOT + v) *
  // PT_BLOCK]: a warp's 32 lanes hit 32 banks whatever their slots
  extern __shared__ float pt_stacks[];
  float* const stk = pt_stacks + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned lanes_below = (1u << lane) - 1u;
  const bool gamma_on = ldf(T.misc, 3) > 0.0f;
  const bool fres_scene = ldf(T.misc, 4) > 0.0f;
  const int cap = 6 * (depth + 1);
  int i = -1;            // this lane's sample; -1 between samples
  bool drained = false;  // the queue had no sample left for this lane
  int most = 0;          // the most nodes any sample of this lane ran
  int it = 0, dep = 0, sp = 0;
  unsigned seed = 0u;
  Ray r;
  float thr[3], acc[3];
  for (;;) {
    const unsigned want = __ballot_sync(FULL_WARP, i < 0 && !drained);
    if (want) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if ((int)lane == leader) base = atomicAdd(queue, __popc(want));
      base = __shfl_sync(FULL_WARP, base, leader);
      if (i < 0 && !drained) {
        const int k = base + __popc(want & lanes_below);
        if (k < n) {
          i = k;
          r.ox = rays[i];
          r.oy = rays[n + i];
          r.oz = rays[2 * n + i];
          r.dx = rays[3 * n + i];
          r.dy = rays[4 * n + i];
          r.dz = rays[5 * n + i];
          r.tmn = rays[6 * n + i];
          r.tmx = BIG;
          r.osrf = -1;
          r.oside = 1;
          r.thru = false;
          r.olx = r.oly = r.olz = 0.0f;
          seed = (unsigned)seeds[i];
          for (int c = 0; c < 3; ++c) {
            thr[c] = 1.0f;
            acc[c] = 0.0f;
          }
          it = dep = sp = 0;
        } else {
          drained = true;
        }
      }
    }
    if (!__any_sync(FULL_WARP, i >= 0)) break;
    if (i < 0) continue;   // drained: wait at the top for the warp
    ++it;
    Hit hb;
    if (CULL)
      nearest_reach(T, r, hb);
    else
      nearest_all<false>(T, r, hb);
    const float u1 = lcg_uniform(seed);
    const float u2 = lcg_uniform(seed);
    const float urr = lcg_uniform(seed);
    const float usplit = lcg_uniform(seed);
    bool cont = false;
    if (hb.t < BIG) {
      const float nn = __frsqrt_rn(
          maxn(hb.nx * hb.nx + hb.ny * hb.ny + hb.nz * hb.nz, 1e-30f));
      const float nx = hb.nx * nn, ny = hb.ny * nn, nz = hb.nz * nn;
      const float* M;
      float mc[3];
      const int props = hit_material(T, hb, gamma_on, mc, M);

      // emission of the hit side (s_emis, packed in sp_f 38-43)
      const float* E =
          T.sp_f + (size_t)hb.row * PF + (hb.side > 0 ? 38 : 41);
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + thr[c] * ldf(E, c);

      const float dx = r.dx, dy = r.dy, dz = r.dz;
      const Fresnel fr = fresnel(props, M, fres_scene, dx, dy, dz, nx, ny,
                                 nz);
      if (!(props & PROP_LIGHT) && dep < depth) {
        // Fresnel branch weights: both at the top PT_SHALLOW levels, a
        // defensively sampled one below (tracer.cpp:3428-3466); opaque
        // mirrors (RF section) are deterministic, never split
        float w_rfl = fr.c_rfl, w_trn = fr.c_trn;
        if (props & PROP_OPAQUE) {
          w_trn = 0.0f;
        } else if (dep >= PT_SHALLOW) {
          const float s_rt = maxn(fr.c_rfl + fr.c_trn, 1e-30f);
          const float qd = 0.25f + 0.5f * fr.c_rfl / s_rt;
          if (usplit < qd) {
            w_rfl = fr.c_rfl / qd;
            w_trn = 0.0f;
          } else {
            w_rfl = 0.0f;
            w_trn = fr.c_trn / maxn(1.0f - qd, 1e-30f);
          }
        }
        // diffuse child: Russian roulette below depth-5
        const bool deep = dep >= depth - 5;
        const float q =
            clampn(maxn(maxn(mc[0], mc[1]), mc[2]), 1e-4f, 1.0f);
        const bool have_dif =
            (props & PROP_DIFFUSE) && !(deep && urr >= q);
        const bool have_trn = w_trn > 0.0f;
        const bool have_rfl = w_rfl > 0.0f;
        const bool cont_trn = !have_dif && have_trn;
        const bool cont_rfl = !have_dif && !have_trn && have_rfl;
        cont = have_dif || have_trn || have_rfl;

        const float ddn = dx * nx + dy * ny + dz * nz;
        const float mrx = dx - 2.0f * ddn * nx;
        const float mry = dy - 2.0f * ddn * ny;
        const float mrz = dz - 2.0f * ddn * nz;
        for (int b = 0; b < 2; ++b) {
          const bool rfl = b == 0;
          if (!(rfl ? have_rfl && !cont_rfl : have_trn && !cont_trn) ||
              sp >= PT_STACK)
            continue;
          const float w = rfl ? w_rfl : w_trn;
          float* slot = stk + sp * PT_SLOT * PT_BLOCK;
          slot[0 * PT_BLOCK] = hb.wx;
          slot[1 * PT_BLOCK] = hb.wy;
          slot[2 * PT_BLOCK] = hb.wz;
          slot[3 * PT_BLOCK] = rfl ? mrx : fr.rfx;
          slot[4 * PT_BLOCK] = rfl ? mry : fr.rfy;
          slot[5 * PT_BLOCK] = rfl ? mrz : fr.rfz;
          for (int c = 0; c < 3; ++c) slot[(6 + c) * PT_BLOCK] = thr[c] * w;
          const unsigned word = (unsigned)(dep + 1) |
                                (hb.side > 0 ? 1u << 10 : 0u) |
                                (rfl ? 0u : 1u << 11) |
                                ((unsigned)hb.srf << 12);
          slot[9 * PT_BLOCK] = __int_as_float((int)word);
          ++sp;
        }
        if (have_dif) {
          // cosine-weighted hemisphere about n (ops/pt.py basis); cos
          // and sin in double, rounded once
          const bool near_z = fabsf(nz) < 0.9f;
          const float ax = near_z ? 0.0f : 1.0f;
          const float az = near_z ? 1.0f : 0.0f;
          float t1x = -az * ny;
          float t1y = az * nx - ax * nz;
          float t1z = ax * ny;
          const float t1n = __frsqrt_rn(
              maxn(t1x * t1x + t1y * t1y + t1z * t1z, 1e-20f));
          t1x = t1x * t1n; t1y = t1y * t1n; t1z = t1z * t1n;
          const float t2x = ny * t1z - nz * t1y;
          const float t2y = nz * t1x - nx * t1z;
          const float t2z = nx * t1y - ny * t1x;
          const float rr = __fsqrt_rn(maxn(u1, 0.0f));
          const float phi = 6.28318530717958647692f * u2;
          const float xx = rr * __double2float_rn(cos((double)phi));
          const float yy = rr * __double2float_rn(sin((double)phi));
          const float zz = __fsqrt_rn(maxn(1.0f - u1, 0.0f));
          r.dx = t1x * xx + t2x * yy + nx * zz;
          r.dy = t1y * xx + t2y * yy + ny * zz;
          r.dz = t1z * xx + t2z * yy + nz * zz;
          const float dq = deep ? 1.0f / q : 1.0f;
          const float m_dff = ldf(M, 3);
          for (int c = 0; c < 3; ++c) thr[c] = thr[c] * (mc[c] * m_dff * dq);
        } else if (cont_trn) {
          r.dx = fr.rfx; r.dy = fr.rfy; r.dz = fr.rfz;
          for (int c = 0; c < 3; ++c) thr[c] = thr[c] * w_trn;
        } else if (cont_rfl) {
          r.dx = mrx; r.dy = mry; r.dz = mrz;
          for (int c = 0; c < 3; ++c) thr[c] = thr[c] * w_rfl;
        }
        if (cont) {
          r.ox = hb.wx; r.oy = hb.wy; r.oz = hb.wz;
          dep = dep + 1;
          r.osrf = hb.srf;
          r.oside = hb.side;
          r.thru = cont_trn;
          r.tmn = 0.0f;
        }
      }
    }
    bool live = cont;
    if (!cont && sp > 0) {
      // pop a pending sibling
      --sp;
      const float* slot = stk + sp * PT_SLOT * PT_BLOCK;
      r.ox = slot[0 * PT_BLOCK];
      r.oy = slot[1 * PT_BLOCK];
      r.oz = slot[2 * PT_BLOCK];
      r.dx = slot[3 * PT_BLOCK];
      r.dy = slot[4 * PT_BLOCK];
      r.dz = slot[5 * PT_BLOCK];
      for (int c = 0; c < 3; ++c) thr[c] = slot[(6 + c) * PT_BLOCK];
      const unsigned word = (unsigned)__float_as_int(slot[9 * PT_BLOCK]);
      dep = (int)(word & PT_MAX_DEPTH);
      r.oside = (word >> 10) & 1u ? 1 : -1;
      r.thru = (word >> 11) & 1u;
      r.osrf = (int)(word >> 12);
      r.tmn = 0.0f;
      live = true;
    }
    if (!live || it == cap) {   // retired
      out[i] = acc[0];
      out[n + i] = acc[1];
      out[2 * n + i] = acc[2];
      most = max(most, it);
      i = -1;
    }
  }
  // every lane of the warp is here: the call's node count M, once a warp
  const int mx = __reduce_max_sync(FULL_WARP, most);
  if (lane == 0) atomicMax(iters, mx);
}

// Every seed advanced 4*M draws, M = *iters (written by pt_kernel, which
// runs before this on the same stream): the jnp tracer draws four
// uniforms per lane per iteration while any lane of the call is active.
// x -> A x + C mod 2^32 with (A, C) the 4M-fold LCG step, by squaring.
__global__ void __launch_bounds__(256)
pt_seed_tail(const int* __restrict__ seeds, int* __restrict__ seeds_out,
             int n, const int* __restrict__ iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned k = 4u * (unsigned)*iters;
  unsigned a = 1u, c = 0u, ap = LCG_A, cp = LCG_C;
  while (k) {
    if (k & 1u) {
      c = ap * c + cp;
      a = ap * a;
    }
    cp = ap * cp + cp;
    ap = ap * ap;
    k >>= 1;
  }
  seeds_out[i] = (int)(a * (unsigned)seeds[i] + c);
}

}  // namespace

// The scene tables of every entry point, in ops/cuda_kernel.py
// _scene_tables order; rows is the height of the permuted tables
#define SCENE_PARAMS                                                      \
  const float *sp_f, const int *sp_i, const float *cl_f,                 \
      const float *mat_f, const int *mat_i, const float *lg_f,           \
      const float *misc, const int *tex_pk, const float *tex_lut,        \
      const float *bsph, const int *shad, const int *cont, int rows
#define SCENE_TABLES(ns, nc, nl)                                          \
  Tables {                                                                \
    sp_f, sp_i, cl_f, mat_f, mat_i, lg_f, misc, tex_pk, tex_lut, bsph,    \
        shad, cont, ns, nc, nl, (rows + 31) / 32, (rows + 127) / 128 * 128 \
  }

// a culled launch needs its real surfaces in the warp's mask words
static bool fits(int ns, int cull) {
  return ns >= 0 && (cull == 0 || ns <= 32 * MAX_WORDS);
}

// the persistent grids' caches of resident_blocks, one for each kernel
// (resume_sparse's two and the path-record kernel's twelve, by SCHLICK
// and paths_kind)
enum { RES_PT, RES_PT_CULL, RES_RESUME_SPARSE, RES_PATHS =
       RES_RESUME_SPARSE + 2, RES_KERNELS = RES_PATHS + 12 };

// *blocks := the blocks of `kernel` (block threads, smem bytes of dynamic
// shared memory, allowed to it above 48 KB; its cache `slot`) that the
// current card holds at once, queried once per device
static cudaError_t resident_blocks(const void* kernel, int block,
                                   size_t smem, int slot, int* blocks) {
  constexpr int MAX_DEVICES = 64;
  static int resident[RES_KERNELS][MAX_DEVICES];
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[slot][dev] == 0) {
    int per_sm = 0, sms = 0;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        block, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[slot][dev] = per_sm * sms;
  }
  *blocks = resident[slot][dev];
  return cudaSuccess;
}

// whitted_kernel<ROUND, cull != 0> over n threads, culled with per-ray
// masks where OWN, Schlick's F where cfg.schlick
template <int ROUND, bool OWN, bool SCHLICK>
static int launch_as(const float* rays, float* out, float* state,
                     const int* idx, const int* count, int n,
                     const Tables& T, const Cfg& cfg, void* stream) {
  const dim3 block(W_BLOCK), grid((unsigned)((n + W_BLOCK - 1) / W_BLOCK));
  cudaStream_t s = (cudaStream_t)stream;
  if (cfg.cull)
    whitted_kernel<ROUND, true, OWN, SCHLICK><<<grid, block, 0, s>>>(
        rays, out, state, idx, count, n, T, cfg);
  else
    whitted_kernel<ROUND, false, false, SCHLICK><<<grid, block, 0, s>>>(
        rays, out, state, idx, count, n, T, cfg);
  return (int)cudaGetLastError();
}
template <int ROUND, bool OWN>
static int launch(const float* rays, float* out, float* state,
                  const int* idx, const int* count, int n, const Tables& T,
                  const Cfg& cfg, void* stream) {
  return cfg.schlick ? launch_as<ROUND, OWN, true>(rays, out, state, idx,
                                                   count, n, T, cfg, stream)
                     : launch_as<ROUND, OWN, false>(rays, out, state, idx,
                                                    count, n, T, cfg, stream);
}

// The plan of a scene's tables in a block's shared memory (Staging; ns
// real surfaces, clip width nc, nm materials, nl active lights): false
// where they do not fit in PATHS_SMEM without cl_f, which goes in where
// it fits too
static bool paths_staging(int ns, int nc, int nm, int nl, Staging& st) {
  const long long bytes[P_TABLES] = {
      4LL * ns * PF, 4LL * ns * SI, 4LL * ns * nc * CF, 4LL * nm * MF,
      4LL * nm * MI, 4LL * nl * LF, 4LL * 8};
  const auto pad = [](long long b) { return (b + 15) & ~15LL; };
  long long core = 16;   // the mbarrier's 8 bytes, padded
  for (int k = 0; k < P_TABLES; ++k)
    if (k != 2) core += pad(bytes[k]);
  if (core > PATHS_SMEM) return false;
  const bool cl = core + pad(bytes[2]) <= PATHS_SMEM;
  long long off = 16;
  for (int k = 0; k < P_TABLES; ++k) {
    st.off[k] = (int)off;
    st.bytes[k] = k == 2 && !cl ? 0 : (int)bytes[k];
    off += pad(st.bytes[k]);
  }
  st.total = (int)off;
  return true;
}

// paths_kernel's instantiations, indexed by paths_kind
using PathsKernel = void (*)(const float*, float*, int*, int, Tables, Cfg,
                             Staging, int*);
static int paths_kind(bool cull, bool sm, bool own) {
  return cull ? 2 + 2 * own + sm : sm;
}
template <bool S>
static PathsKernel paths_instance(int kind) {
  static const PathsKernel kernels[6] = {
      paths_kernel<false, false, false, S>,
      paths_kernel<false, true, false, S>,
      paths_kernel<true, false, false, S>,
      paths_kernel<true, true, false, S>,
      paths_kernel<true, false, true, S>,
      paths_kernel<true, true, true, S>};
  return kernels[kind];
}

// whole_kernel's instantiations: by the branch stack (0 none, 1 MAX_STACK
// local slots, 2 the scratch), then the walk (0 unculled, 1 culled, 2
// culled with per-ray masks)
using WholeKernel = void (*)(const float*, float*, int, Tables, Cfg, float*);
template <bool S>
static WholeKernel whole_instance(int stack, int walk) {
  static const WholeKernel kernels[3][3] = {
      {whole_kernel<false, false, false, false, S>,
       whole_kernel<false, true, false, false, S>,
       whole_kernel<false, true, true, false, S>},
      {whole_kernel<true, false, false, false, S>,
       whole_kernel<true, true, false, false, S>,
       whole_kernel<true, true, true, false, S>},
      {whole_kernel<true, false, false, true, S>,
       whole_kernel<true, true, false, true, S>,
       whole_kernel<true, true, true, true, S>}};
  return kernels[stack][walk];
}

// C entry point (bound with ctypes): launches on `stream` and returns the
// cudaError_t of the launch; allocates nothing and does not synchronise.
// rays: (7, n) f32 SoA (ox oy oz dx dy dz tmin); out: (3, n) f32 SoA;
// cull: the culling gates (Cfg.cull bits); coop_max (0..32): a culled
// warp with at most this many rays left runs them one at a time on all
// its lanes (0 never, 32 from the first segment); own_min (>= 0) and
// own_max: culled, the per-ray masks after the camera segment refine a
// warp's mask that keeps more than own_min surfaces, in a launch of at
// most own_max rays (a batch of several frames keeps the card busy, and
// there the refinement costs more than it saves); schlick: Schlick's F;
// deep: where can_push and d = min(stack, max_segments) > MAX_STACK, a
// scratch of (n, d, SLOT) f32 the caller allocates for the branch stacks
// (ops/cuda_kernel.py whitted_scratch), otherwise not read. A scene that
// cannot push reads no stack, so any stack >= 1 is taken. Launches
// whole_kernel on ceil(n / W_BLOCK) blocks. coop_max, own_min, own_max,
// schlick and deep come after the stream, so that a caller of an entry
// point from before them passes the arguments it reads.
extern "C" int whitted_launch(
    const float* rays, float* out, SCENE_PARAMS, int n, int ns, int nc,
    int nl, int depth, int max_segments, int stack, float cutoff,
    int can_push, int cull, void* stream, int coop_max, int own_min,
    int own_max, int schlick, float* deep) {
  if (n <= 0) return 0;
  const int d = stack < max_segments ? stack : max_segments;
  const bool in_deep = can_push && d > MAX_STACK;
  if (stack < 1 || !fits(ns, cull) || coop_max < 0 || coop_max > 32 ||
      own_min < 0 || (in_deep && deep == nullptr))
    return (int)cudaErrorInvalidValue;
  const Tables T = SCENE_TABLES(ns, nc, nl);
  const Cfg cfg{depth,    max_segments, stack,   cutoff,
                cull,     coop_max,     own_min, schlick};
  // culled, per-ray masks after the camera segment where there is a
  // segment after it and more than own_min surfaces to refine, as EMIT
  const bool own = cull && max_segments > 1 && ns > own_min && n <= own_max;
  const int stack_kind = in_deep ? 2 : can_push != 0;
  const int walk = cull ? 1 + own : 0;
  const WholeKernel kern = schlick ? whole_instance<true>(stack_kind, walk)
                                   : whole_instance<false>(stack_kind, walk);
  kern<<<(unsigned)((n + W_BLOCK - 1) / W_BLOCK), W_BLOCK, 0,
         (cudaStream_t)stream>>>(rays, out, n, T, cfg, deep);
  return (int)cudaGetLastError();
}

// The differentiable route's forward: tape_kernel on ceil(n / W_BLOCK)
// blocks. out: (3, n) f32 SoA colours; tf: (max_segments, 12, n) f32 and
// ti: (max_segments, words, n) i32, the tape (ops/diff.py), every element
// written; words: 2 + ceil(light rows / 32); schlick: Schlick's F. Unculled,
// whatever the tables' culling words hold. The branch stack holds d =
// min(stack, max_segments) slots: the instantiation of the least of 4, 8
// and 16 local slots that holds them, else (d > 16) deep, a scratch of (n,
// d, 15) f32 the caller allocates (ops/diff.py stack_scratch).
extern "C" int whitted_tape_launch(
    const float* rays, float* out, float* tf, int* ti, SCENE_PARAMS, int n,
    int ns, int nc, int nl, int words, int depth, int max_segments,
    int stack, float cutoff, int schlick, float* deep, void* stream) {
  if (n <= 0 || max_segments <= 0) return 0;
  if (stack < 0 || ns < 0 || words < 2 + (nl + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const int d = stack < max_segments ? stack : max_segments;
  if (d > 16 && deep == nullptr) return (int)cudaErrorInvalidValue;
  const Tables T = SCENE_TABLES(ns, nc, nl);
  const Cfg cfg{depth, max_segments, stack, cutoff, 0, 0, 0, schlick};
  using TapeKernel = void (*)(const float*, float*, float*, int*, int, int,
                              Tables, Cfg, float*, int);
  const TapeKernel kern = d <= 4    ? tape_kernel<4>
                          : d <= 8  ? tape_kernel<8>
                          : d <= 16 ? tape_kernel<16>
                                    : tape_kernel<0>;
  kern<<<(unsigned)((n + W_BLOCK - 1) / W_BLOCK), W_BLOCK, 0,
         (cudaStream_t)stream>>>(rays, out, tf, ti, n, words, T, cfg, deep,
                                 d);
  return (int)cudaGetLastError();
}

// Path-record entry point, for a single-branch scene of at most 16 active
// lights: segments capped at k; out: (3, n) f32 SoA colours; paths: (k,
// n) i32, every element written by the kernel (no zeroing needed); queue:
// one i32 of scratch, the work queue, zeroed here; nm: the material rows;
// own_min (>= 0): culled, the per-ray masks after the camera segment
// refine a warp's mask that keeps more than this many surfaces. Launches
// paths_kernel on the persistent grid (the blocks of the instantiation
// that fit on the card at once, or fewer when n needs fewer): with the
// tables in shared memory where paths_staging says they fit, else the
// instantiation that reads them in device memory; schlick: Schlick's F.
// queue, nm, own_min and schlick come after the stream, so that a caller
// of an entry point from before them passes the arguments it reads.
extern "C" int whitted_paths_launch(
    const float* rays, float* out, int* paths, SCENE_PARAMS, int n, int ns,
    int nc, int nl, int depth, int k, float cutoff, int cull,
    void* stream, int* queue, int nm, int own_min, int schlick) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (k < 1 || nl < 0 || nl > 16 || !fits(ns, cull) || nc < 0 || nm < 0 ||
      own_min < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(queue, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const Tables T = SCENE_TABLES(ns, nc, nl);
  const Cfg cfg{depth, k, 1, cutoff, cull, 0, own_min, schlick};
  Staging st{};
  const bool sm = paths_staging(ns, nc, nm, nl, st);
  // the bulk copies read from 16-byte boundaries
  const void* src[P_TABLES] = {sp_f, sp_i, cl_f, mat_f, mat_i, lg_f, misc};
  for (int t = 0; sm && t < P_TABLES; ++t)
    if (st.bytes[t] && ((size_t)src[t] & 15u))
      return (int)cudaErrorMisalignedAddress;
  // culled, per-ray masks after the camera segment where there is a
  // segment after it and more than own_min surfaces to refine, as EMIT
  const bool own = cull && k > 1 && ns > own_min;
  const int kind = paths_kind(cull != 0, sm, own);
  const PathsKernel kern = schlick ? paths_instance<true>(kind)
                                   : paths_instance<false>(kind);
  int resident = 0;
  err = resident_blocks((const void*)kern, P_BLOCK, sm ? PATHS_SMEM : 0,
                        RES_PATHS + (schlick ? 6 : 0) + kind, &resident);
  if (err != cudaSuccess) return (int)err;
  const int need = (n + P_BLOCK - 1) / P_BLOCK;
  const int blocks = need < resident ? need : resident;
  kern<<<(unsigned)blocks, P_BLOCK, sm ? st.total : 0, s>>>(
      rays, out, paths, n, T, cfg, st, queue);
  return (int)cudaGetLastError();
}

// Round 1 of two-round retirement, for a single-branch scene: as
// whitted_launch with segments capped at k1, plus state: (21, n) f32, the
// resumable ray state of every ray (rows as in the file header), every
// element written by the kernel. Culled, the camera segment takes the
// warp's masks and the segments after it per-ray masks within a warp's
// that keeps more than own_min (>= 0) surfaces (the OWN instantiation);
// schlick: Schlick's F. own_min and schlick come after the stream, so that
// a caller of an entry point from before them passes the arguments it
// reads.
extern "C" int whitted_emit_launch(
    const float* rays, float* out, float* state, SCENE_PARAMS, int n,
    int ns, int nc, int nl, int depth, int k1, float cutoff, int cull,
    void* stream, int own_min, int schlick) {
  if (n <= 0) return 0;
  if (k1 < 1 || !fits(ns, cull) || own_min < 0)
    return (int)cudaErrorInvalidValue;
  const Tables T = SCENE_TABLES(ns, nc, nl);
  const Cfg cfg{depth, k1, 1, cutoff, cull, 0, own_min, schlick};
  // k1 = 1 has no segment after the camera's, and a scene of at most
  // own_min surfaces no mask to refine: the warp's masks alone
  return k1 > 1 && ns > own_min
             ? launch<EMIT, true>(rays, out, state, nullptr, nullptr, n, T,
                                  cfg, stream)
             : launch<EMIT, false>(rays, out, state, nullptr, nullptr, n, T,
                                   cfg, stream);
}

// Round 2: resumes the rays idx[0..*count) of state (written by
// whitted_emit_launch; idx and count live on the device, count <= n) for
// at most `segments` more segments and overwrites their colours in out,
// the (3, n) buffer round 1 wrote. warp_max (0..n): up to that many
// survivors run a warp each (resume_sparse, on a grid of at most
// warp_max warps, capped at what the card holds at once), more run a
// thread each (the dense whitted_kernel, whose grid covers n threads);
// both are launched on `stream` and the one whose range *count is not in
// returns at once. 0: dense always; n: sparse always; 0 for a scene of
// more real surfaces than the mask words hold (1024). The dense mode's
// per-ray masks refine a warp's that keeps more than own_min (>= 0)
// surfaces; schlick: Schlick's F. warp_max, own_min and schlick come after
// the stream, so that a caller of an entry point from before them passes
// the arguments it reads.
extern "C" int whitted_resume_launch(
    const float* state, const int* idx, const int* count, float* out,
    SCENE_PARAMS, int n, int ns, int nc, int nl, int depth, int segments,
    float cutoff, int cull, void* stream, int warp_max, int own_min,
    int schlick) {
  if (n <= 0) return 0;
  if (segments < 1 || !fits(ns, cull) || warp_max < 0 || warp_max > n ||
      (warp_max > 0 && !fits(ns, 1)) || own_min < 0)
    return (int)cudaErrorInvalidValue;
  const Tables T = SCENE_TABLES(ns, nc, nl);
  const Cfg cfg{depth,    segments, 1,       cutoff,
                cull,     warp_max, own_min, schlick};
  if (warp_max > 0) {
    using Sparse = void (*)(const float*, const int*, const int*, float*,
                            int, Tables, Cfg);
    const Sparse kern = schlick ? resume_sparse<true> : resume_sparse<false>;
    int resident = 0;
    cudaError_t err = resident_blocks((const void*)kern, W_BLOCK, 0,
                                      RES_RESUME_SPARSE + (schlick ? 1 : 0),
                                      &resident);
    if (err != cudaSuccess) return (int)err;
    const int need = (warp_max + W_BLOCK / 32 - 1) / (W_BLOCK / 32);
    const int blocks = need < resident ? need : resident;
    kern<<<(unsigned)blocks, W_BLOCK, 0, (cudaStream_t)stream>>>(
        state, idx, count, out, n, T, cfg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return launch<RESUME, true>(nullptr, out, const_cast<float*>(state), idx,
                              count, n, T, cfg, stream);
}

// Path-tracing entry point: one sample per ray. seeds: (n,) i32 LCG
// states in, seeds_out: (n,) i32 out (each advanced 4*M draws); iters: two
// i32 of scratch, zeroed here: iters[0] ends holding M, iters[1] is the
// work queue's next sample; cull: the culling gates (Cfg.cull bits:
// reach only in PT mode), after the stream, so that a caller of an entry
// point from before PT culling passes the arguments it reads. Launches
// pt_kernel (culled when cull is non-zero) on the persistent grid (the
// blocks of that instantiation that fit on the card at once, queried once
// per device, or fewer when n needs fewer), then pt_seed_tail, on
// `stream`.
extern "C" int whitted_pt_launch(
    const float* rays, const int* seeds, float* out, int* seeds_out,
    int* iters, SCENE_PARAMS, int n, int ns, int nc, int nl, int depth,
    void* stream, int cull) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(iters, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  if (depth < 0 || depth > PT_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  const int c = cull ? 1 : 0;
  int resident = 0;
  err = resident_blocks(
      c ? (const void*)pt_kernel<true> : (const void*)pt_kernel<false>,
      PT_BLOCK, PT_SMEM, c ? RES_PT_CULL : RES_PT, &resident);
  if (err != cudaSuccess) return (int)err;
  const Tables T = SCENE_TABLES(ns, nc, nl);
  const int need = (n + PT_BLOCK - 1) / PT_BLOCK;
  const int blocks = need < resident ? need : resident;
  if (c)
    pt_kernel<true><<<(unsigned)blocks, PT_BLOCK, PT_SMEM, s>>>(
        rays, seeds, out, n, T, depth, iters, iters + 1);
  else
    pt_kernel<false><<<(unsigned)blocks, PT_BLOCK, PT_SMEM, s>>>(
        rays, seeds, out, n, T, depth, iters, iters + 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pt_seed_tail<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(seeds, seeds_out,
                                                          n, iters);
  return (int)cudaGetLastError();
}
