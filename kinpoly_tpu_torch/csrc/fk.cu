// Forward kinematics of a tree of rigid bodies (K5), and the per-dof world
// frames of its hinges, in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: kinpoly_tpu/physics/fk.py (fk, dof_frames) is
// plain jnp, which XLA fuses into a few kernels on the TPU. In PyTorch the
// same code runs op by op: ~870 launches of ~1 us per call, 18 calls per
// UHC control step. Plain versions: kinpoly_tpu_torch/physics/fk.py
// _fk_plain and dof_frames.
//
// What bounds it on the card. Per env it reads the qpos row (76 floats for
// the 24-body humanoid) and writes xpos, xquat and xipos (240 floats), and
// with the frames also the axes and anchors of the 75 dofs (450 more): at
// 1024 envs 1.3 MB (fk) or 3.1 MB (fk + frames), 0.4-0.9 us at 3.35 TB/s.
// The work, ~1.5 kflop per env, is far below the card's float32 rate. So
// bytes bound it, and at the main path's 1024 envs a launch's latency,
// a few us, is larger than either.
//
// Design. One warp per env, lane b holding body b (at most 32 bodies).
// Each lane reads its three hinge angles (lane 0 the root's position and
// quaternion) from the env's row: one warp touches one row, so the reads
// coalesce. Each lane forms its local z-y-x quaternion, then the warp walks
// the tree level by level (the wrapper's table gives each body its parent
// and depth): at level d the lanes at depth d take their parent's world
// quaternion and position with __shfl_sync and compose them. Nothing but
// the outputs leaves registers, and the only synchronisation is the warp's
// own shuffles. With the frames, each lane also turns its z, y and x hinge
// axes by the parent's orientation and the hinges before them, and lane 0
// writes the free joint's six axes.
// The arithmetic is the plain version's, in float32, op for op and in the
// same order (quat_norm with its 1e-12 floor, quat_from_euler "rzyx",
// quat_mul, quat_rot_vec, quat_to_mat), with sinf/cosf, IEEE division and
// square root and no FMA contraction beyond PyTorch's own: on the card it
// gives the plain code's results bit for bit. That matters beyond
// tidiness: a contact whose depth is within a rounding step of zero is on
// or off by that rounding, and one more contact moves an env's velocities
// by tenths within a substep.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;          // envs per block
constexpr unsigned kFull = 0xffffffffu;

struct Quat {
  float w, x, y, z;
};

struct Vec {
  float x, y, z;
};

// One IEEE operation per product, sum and quotient, rounded alone as
// PyTorch's elementwise kernels round them (no FMA contraction), so that
// the kernel gives the plain code's float32 results on the card bit for
// bit. Two exceptions follow PyTorch's own kernels: torch.linalg.cross
// contracts a b - c d into fma(a, b, -(c d)), and torch.sum over four
// entries adds them as (0 + 2) + (1 + 3).
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// sum(q * q) over the four entries, in torch.sum's order
__device__ __forceinline__ float sum_sq(const Quat& q) {
  return add(add(mul(q.w, q.w), mul(q.y, q.y)), add(mul(q.x, q.x), mul(q.z, q.z)));
}

// tmath.quat_mul (the rotation b, then a), left to right as written there
__device__ __forceinline__ Quat qmul(const Quat& a, const Quat& b) {
  return {sub(sub(sub(mul(a.w, b.w), mul(a.x, b.x)), mul(a.y, b.y)), mul(a.z, b.z)),
          sub(add(add(mul(a.w, b.x), mul(a.x, b.w)), mul(a.y, b.z)), mul(a.z, b.y)),
          add(add(sub(mul(a.w, b.y), mul(a.x, b.z)), mul(a.y, b.w)), mul(a.z, b.x)),
          add(sub(add(mul(a.w, b.z), mul(a.x, b.y)), mul(a.y, b.x)), mul(a.z, b.w))};
}

// torch.linalg.cross
__device__ __forceinline__ Vec cross(const Vec& a, const Vec& b) {
  return {__fmaf_rn(a.y, b.z, -mul(a.z, b.y)), __fmaf_rn(a.z, b.x, -mul(a.x, b.z)),
          __fmaf_rn(a.x, b.y, -mul(a.y, b.x))};
}

// tmath.quat_rot_vec: v + 2 (w (u x v) + u x (u x v)), u the vector part
__device__ __forceinline__ Vec rot(const Quat& q, const Vec& v) {
  const Vec u{q.x, q.y, q.z};
  const Vec uv = cross(u, v);
  const Vec uuv = cross(u, uv);
  return {add(v.x, mul(2.0f, add(mul(q.w, uv.x), uuv.x))),
          add(v.y, mul(2.0f, add(mul(q.w, uv.y), uuv.y))),
          add(v.z, mul(2.0f, add(mul(q.w, uv.z), uuv.z)))};
}

__device__ __forceinline__ Quat shfl(const Quat& q, int src) {
  return {__shfl_sync(kFull, q.w, src), __shfl_sync(kFull, q.x, src),
          __shfl_sync(kFull, q.y, src), __shfl_sync(kFull, q.z, src)};
}

__device__ __forceinline__ Vec shfl(const Vec& v, int src) {
  return {__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
          __shfl_sync(kFull, v.z, src)};
}

__device__ __forceinline__ void store(float* p, const Vec& v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

// tree: parents (B ints, the root's -1), then depths (B ints, the root's 0);
// n_level = the greatest depth. qpos (n, 7 + 3 (B - 1)); xpos, xipos
// (n, B, 3); xquat (n, B, 4); with Frames, axis and anchor (n, 6 + 3 (B - 1), 3).
template <bool Frames>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
fk_tree_kernel(const float* __restrict__ qpos, const int* __restrict__ tree,
               const float* __restrict__ body_pos,
               const float* __restrict__ body_ipos, float* __restrict__ xpos,
               float* __restrict__ xquat, float* __restrict__ xipos,
               float* __restrict__ axis, float* __restrict__ anchor, int n_env,
               int n_body, int n_level) {
  const int lane = threadIdx.x % kWarp;
  const long long env =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (env >= n_env) return;  // the whole warp: the shuffles keep full masks
  const int nq = 7 + 3 * (n_body - 1);
  const float* q = qpos + env * nq;
  const bool live = lane < n_body;
  const int parent = live && lane > 0 ? tree[lane] : lane;
  const int depth = live ? tree[n_body + lane] : -1;

  // the root: tmath.quat_norm(qpos[3:7]), eps 1e-12 floored before the sqrt
  Quat xq{1.0f, 0.0f, 0.0f, 0.0f};
  Vec xp{0.0f, 0.0f, 0.0f};
  Quat root{1.0f, 0.0f, 0.0f, 0.0f};
  if (lane == 0) {
    xp = {q[0], q[1], q[2]};
    const Quat r{q[3], q[4], q[5], q[6]};
    const float nrm = __fsqrt_rn(fmaxf(sum_sq(r), 1e-24f));
    root = {__fdiv_rn(r.w, nrm), __fdiv_rn(r.x, nrm), __fdiv_rn(r.y, nrm),
            __fdiv_rn(r.z, nrm)};
    xq = root;
  }
  // a hinge body: quat_from_euler(z, y, x, "rzyx") of its three angles
  Quat local{1.0f, 0.0f, 0.0f, 0.0f};
  float ck = 1.0f, sk = 0.0f, cj = 1.0f, sj = 0.0f;
  if (live && lane > 0) {
    const float* a = q + 7 + 3 * (lane - 1);
    const float hk = mul(a[0], 0.5f), hj = mul(a[1], 0.5f), hi = mul(a[2], 0.5f);
    const float ci = cosf(hi), si = sinf(hi);
    cj = cosf(hj);
    sj = sinf(hj);
    ck = cosf(hk);
    sk = sinf(hk);
    const float cc = mul(ci, ck), cs = mul(ci, sk), sc = mul(si, ck),
                ss = mul(si, sk);
    local = {add(mul(cj, cc), mul(sj, ss)), sub(mul(cj, sc), mul(sj, cs)),
             add(mul(cj, ss), mul(sj, cc)), sub(mul(cj, cs), mul(sj, sc))};
  }

  // the walk: level d composes the bodies at depth d onto their parents
  Quat pq{1.0f, 0.0f, 0.0f, 0.0f};  // the parent's orientation
  Vec bpos{0.0f, 0.0f, 0.0f};
  if (live) bpos = {body_pos[3 * lane], body_pos[3 * lane + 1], body_pos[3 * lane + 2]};
  for (int d = 1; d <= n_level; ++d) {
    const Quat p = shfl(xq, parent);
    const Vec pp = shfl(xp, parent);
    if (depth == d) {
      pq = p;
      xq = qmul(p, local);
      const Vec r = rot(p, bpos);
      xp = {add(pp.x, r.x), add(pp.y, r.y), add(pp.z, r.z)};
    }
  }
  if (!live) return;

  const long long b0 = env * n_body + lane;
  const Vec ip{body_ipos[3 * lane], body_ipos[3 * lane + 1], body_ipos[3 * lane + 2]};
  const Vec ri = rot(xq, ip);
  store(xpos + 3 * b0, xp);
  store(xipos + 3 * b0, {add(xp.x, ri.x), add(xp.y, ri.y), add(xp.z, ri.z)});
  float* xqo = xquat + 4 * b0;
  xqo[0] = xq.w;
  xqo[1] = xq.x;
  xqo[2] = xq.y;
  xqo[3] = xq.z;
  if (!Frames) return;

  const long long nv = 6 + 3 * (n_body - 1);
  float* ax = axis + 3 * env * nv;
  float* an = anchor + 3 * env * nv;
  if (lane == 0) {
    // the free joint: 3 world axes, then the columns of quat_to_mat(root)
    const float w = root.w, x = root.x, y = root.y, z = root.z;
    const float n = sum_sq(root);
    const float s = n > 1e-12f ? __fdiv_rn(2.0f, fmaxf(n, 1e-12f)) : 0.0f;
    const float sw = mul(s, w), sx = mul(s, x), sy = mul(s, y);
    const float wx = mul(sw, x), wy = mul(sw, y), wz = mul(sw, z);
    const float xx = mul(sx, x), xy = mul(sx, y), xz = mul(sx, z);
    const float yy = mul(sy, y), yz = mul(sy, z), zz = mul(mul(s, z), z);
    const Vec rows[6] = {{1.0f, 0.0f, 0.0f},
                         {0.0f, 1.0f, 0.0f},
                         {0.0f, 0.0f, 1.0f},
                         {sub(1.0f, add(yy, zz)), add(xy, wz), sub(xz, wy)},
                         {sub(xy, wz), sub(1.0f, add(xx, zz)), add(yz, wx)},
                         {add(xz, wy), sub(yz, wx), sub(1.0f, add(xx, yy))}};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      store(ax + 3 * k, rows[k]);
      store(an + 3 * k, xp);
    }
    return;
  }
  // dof_frames' hinges: z about the parent's axes, y after z, x after z, y;
  // about(angle, e) is (cos, sin * e), zero products kept as the plain code
  const Quat qz{ck, mul(sk, 0.0f), mul(sk, 0.0f), sk};
  const Quat qy{cj, mul(sj, 0.0f), sj, mul(sj, 0.0f)};
  const Vec hinge[3] = {rot(pq, {0.0f, 0.0f, 1.0f}),
                        rot(qmul(pq, qz), {0.0f, 1.0f, 0.0f}),
                        rot(qmul(pq, qmul(qz, qy)), {1.0f, 0.0f, 0.0f})};
  const int row = 6 + 3 * (lane - 1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    store(ax + 3 * (row + k), hinge[k]);
    store(an + 3 * (row + k), xp);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// frames = 0: xpos, xquat, xipos; frames = 1: also axis and anchor.
extern "C" int fk_tree(const float* qpos, const int* tree, const float* body_pos,
                       const float* body_ipos, float* xpos, float* xquat,
                       float* xipos, float* axis, float* anchor, int n_env,
                       int n_body, int n_level, int frames, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_env + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * kWarp);
  if (frames)
    fk_tree_kernel<true><<<grid, block, 0, st>>>(qpos, tree, body_pos, body_ipos,
                                                 xpos, xquat, xipos, axis, anchor,
                                                 n_env, n_body, n_level);
  else
    fk_tree_kernel<false><<<grid, block, 0, st>>>(qpos, tree, body_pos, body_ipos,
                                                  xpos, xquat, xipos, axis, anchor,
                                                  n_env, n_body, n_level);
  return static_cast<int>(cudaGetLastError());
}
