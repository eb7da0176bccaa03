// Tree-sparse L^T D L factor (K1) and multi-RHS solve (K2) of the packed
// joint-space inertia matrix, for Hopper (sm_90a).
//
// K1 replaces kinpoly_tpu/physics/pallas_ltdl.py ltdl_factor_pallas
// (_factor_kernel); K2 replaces ltdl_solve_pallas (_solve_kernel). Plain
// versions: kinpoly_tpu_torch/physics/ltdl.py factor / solve.
//
// What bounds them on the card. At the main-path shapes (N = 2048 envs,
// nv = 75, Dmax+1 = 30) only 1221 of the 2250 packed slots of an env are
// live (depth + 1 per row). K1 must move 2 x 10.0 MB (live slots in,
// factor out) and does ~25k flops per env (51 Mflop): bytes bound it,
// ~6 us at 3.35 TB/s. K2 with R = 55 right-hand sides moves 10.0 MB of
// factor plus 2 x 33.8 MB of right-hand sides: ~23 us; with R = 1, ~3.4 us.
// Both kernels copy whole packed rows, padding included, so they move
// 1.84x the bytes K1 needs.
//
// Design. The TPU kernels keep the env batch on the 128 lanes and run the
// elimination as straight-line code. Here one warp owns one env and keeps
// its packed rows (9 KB) in shared memory, loaded and stored with coalesced
// 128-byte transactions from the engine's batch-leading layout, so no
// transpose is needed. The elimination schedule (ancestor table, depth,
// level order) comes from small int32 tables that every lane reads alike.
// K1: for dof k the lanes hold L_s (s < depth <= 29 < 32) and update the
// packed triangle of the ancestors in parallel, one ancestor row per step.
// K2: the lanes take the right-hand-side columns, each column an
// independent sequential solve in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 4;
constexpr size_t kSmemLimit = 48 * 1024;

__global__ void ltdl_factor_kernel(const float* __restrict__ R,
                                   float* __restrict__ out,
                                   const int* __restrict__ anc,
                                   const int* __restrict__ depth,
                                   const int* __restrict__ order,
                                   int n, int nv, int dp1, float reg) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int wib = threadIdx.x / kWarp;
  const int env = blockIdx.x * (blockDim.x / kWarp) + wib;
  if (env >= n) return;  // a whole warp leaves together
  const int sz = nv * dp1;
  float* r = smem + wib * sz;
  const float* src = R + static_cast<size_t>(env) * sz;
  for (int i = lane; i < sz; i += kWarp) r[i] = src[i];
  __syncwarp();

  for (int i = 0; i < nv; ++i) {
    const int k = order[i];
    const int d = depth[k];
    if (d == 0) continue;
    float* rk = r + k * dp1;
    // pivot floor from the INPUT diagonal, as the TPU kernel does
    const float dmin = reg * fmaxf(fabsf(src[k * dp1 + d]), 1.0f);
    const float Dk = fmaxf(rk[d], dmin);
    const float Ls = lane < d ? rk[lane] / Dk : 0.0f;
    __syncwarp();
    if (lane < d) rk[lane] = Ls;
    if (lane == 0) rk[d] = Dk;
    // ancestor a_t (depth t) loses (L_t D_k) L_s at slots s <= t; distinct
    // t are distinct rows, so the lanes never write one address twice
    for (int t = 0; t < d; ++t) {
      const float coef = __shfl_sync(0xffffffffu, Ls, t) * Dk;
      const int a = anc[k * dp1 + t];
      if (lane <= t) r[a * dp1 + lane] -= coef * Ls;
    }
    __syncwarp();
  }
  // floor the pivots the elimination never divided by (depth 0)
  for (int k = lane; k < nv; k += kWarp) {
    if (depth[k] == 0) {
      const float dmin = reg * fmaxf(fabsf(src[k * dp1]), 1.0f);
      r[k * dp1] = fmaxf(r[k * dp1], dmin);
    }
  }
  __syncwarp();
  float* dst = out + static_cast<size_t>(env) * sz;
  for (int i = lane; i < sz; i += kWarp) dst[i] = r[i];
}

__global__ void ltdl_solve_kernel(const float* __restrict__ Rf,
                                  const float* __restrict__ B,
                                  float* __restrict__ X,
                                  const int* __restrict__ anc,
                                  const int* __restrict__ depth,
                                  const int* __restrict__ order,
                                  int n, int nv, int dp1, int nr) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int wib = threadIdx.x / kWarp;
  const int env = blockIdx.x * (blockDim.x / kWarp) + wib;
  if (env >= n) return;
  const int szf = nv * dp1;
  const int szx = nv * nr;
  float* rf = smem + wib * (szf + szx);
  float* x = rf + szf;
  const float* srcf = Rf + static_cast<size_t>(env) * szf;
  const float* srcb = B + static_cast<size_t>(env) * szx;
  for (int i = lane; i < szf; i += kWarp) rf[i] = srcf[i];
  for (int i = lane; i < szx; i += kWarp) x[i] = srcb[i];
  __syncwarp();

  for (int c = lane; c < nr; c += kWarp) {
    // pass 1: L^T y = b, deepest level first (x[k] is final when reached)
    for (int i = 0; i < nv; ++i) {
      const int k = order[i];
      const int d = depth[k];
      const float xk = x[k * nr + c];
      for (int t = 0; t < d; ++t)
        x[anc[k * dp1 + t] * nr + c] -= rf[k * dp1 + t] * xk;
    }
    // pass 2: D^-1
    for (int k = 0; k < nv; ++k) x[k * nr + c] /= rf[k * dp1 + depth[k]];
    // pass 3: L x = z, shallowest level first (ancestors are final)
    for (int i = nv - 1; i >= 0; --i) {
      const int k = order[i];
      const int d = depth[k];
      if (d == 0) continue;
      float acc = rf[k * dp1] * x[anc[k * dp1] * nr + c];
      for (int t = 1; t < d; ++t)
        acc += rf[k * dp1 + t] * x[anc[k * dp1 + t] * nr + c];
      x[k * nr + c] -= acc;
    }
  }
  __syncwarp();
  float* dst = X + static_cast<size_t>(env) * szx;
  for (int i = lane; i < szx; i += kWarp) dst[i] = x[i];
}

int warps_per_block(size_t bytes_per_warp) {
  int w = static_cast<int>(kSmemLimit / bytes_per_warp);
  return w < kMaxWarpsPerBlock ? w : kMaxWarpsPerBlock;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). Sizes are checked by the Python wrapper: dp1 <= 32 and
// the per-warp shared memory fits the 48 KB default.
extern "C" int ltdl_factor(const float* R, float* out, const int* anc,
                           const int* depth, const int* order, int n, int nv,
                           int dp1, float reg, void* stream) {
  const size_t per_warp = sizeof(float) * nv * dp1;
  const int w = warps_per_block(per_warp);
  const int blocks = (n + w - 1) / w;
  ltdl_factor_kernel<<<blocks, w * kWarp, w * per_warp,
                       static_cast<cudaStream_t>(stream)>>>(
      R, out, anc, depth, order, n, nv, dp1, reg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ltdl_solve(const float* Rf, const float* B, float* X,
                          const int* anc, const int* depth, const int* order,
                          int n, int nv, int dp1, int nr, void* stream) {
  const size_t per_warp = sizeof(float) * nv * (dp1 + nr);
  const int w = warps_per_block(per_warp);
  const int blocks = (n + w - 1) / w;
  ltdl_solve_kernel<<<blocks, w * kWarp, w * per_warp,
                      static_cast<cudaStream_t>(stream)>>>(
      Rf, B, X, anc, depth, order, n, nv, dp1, nr);
  return static_cast<int>(cudaGetLastError());
}
