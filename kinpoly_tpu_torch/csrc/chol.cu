// Dense batched Cholesky factor and multi-RHS solve for Hopper (sm_90a):
// K4a chol_solve_only (factor + both triangular solves, factor not
// written), K4b chol_factor_solve (the same, also writing L) and K4c
// chol_apply (both triangular solves with a given L).
//
// They replace kinpoly_tpu/physics/pallas_chol.py chol_solve_only
// (_solve_only_kernel), chol_factor_solve (_factor_solve_kernel) and
// chol_apply (_apply_kernel). Plain versions: kinpoly_tpu_torch/physics/
// chol.py solve_only / factor_solve / apply.
//
// What bounds them on the card. At the engine's shapes (N = 2048 envs,
// n = 75) the factor needs the lower triangle of A (2850 floats, 11.4 KB
// per env) and ~n^3/3 = 141k flops per env; the two solves with R columns
// read B and write X (2 x 16.5 KB per env at R = 55) and do 2 n^2 R =
// 619k flops per env. Bytes and flops are close: ~0.027 ms (bytes) and
// ~0.023 ms (flops) at R = 55, ~0.007 ms (bytes) at R = 1, from HBM at
// 3.35 TB/s and float32 at 67 TFLOP/s.
//
// Design (simple and right first). The TPU kernels put 128 envs on the
// lanes, pad n to 80 and unroll the column recursion. Here one thread
// block owns one env: it loads A's lower triangle (or L's) and B with
// coalesced reads from the batch-leading layout into shared memory
// (n x n with an odd row stride, so column reads hit distinct banks, plus
// n x R: 39 KB at R = 55), and runs the right-looking factor with the
// trailing update spread over the warps (one row per warp, the columns of
// the row over the lanes). The forward and backward solves spread the
// (row, column) pairs of each step over all threads. Every column step is
// two barriers: divide by the pivot, then update.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__device__ __forceinline__ int stride_of(int n) { return n | 1; }

__global__ void chol_kernel(const float* __restrict__ A,
                            const float* __restrict__ B,
                            float* __restrict__ L_out,
                            float* __restrict__ X, int n, int nr,
                            bool factor_input) {
  extern __shared__ float smem[];
  const int ld = stride_of(n);
  float* W = smem;            // n x ld: A's lower triangle, then L
  float* Xs = W + n * ld;     // n x nr: B, then Y, then X
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const size_t env = blockIdx.x;

  const float* a = A + env * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    const int k = idx - i * n;
    if (k <= i) W[i * ld + k] = a[idx];
  }
  const float* b = B + env * n * nr;
  for (int idx = tid; idx < n * nr; idx += blockDim.x) Xs[idx] = b[idx];
  __syncthreads();

  if (factor_input) {
    for (int j = 0; j < n; ++j) {
      const float wjj = W[j * ld + j];
      const float d = sqrtf(wjj);
      for (int i = j + 1 + tid; i < n; i += blockDim.x) W[i * ld + j] /= d;
      __syncthreads();
      if (tid == 0) W[j * ld + j] = wjj / d;
      // W[i][k] -= L[i][j] L[k][j] for j < k <= i: one row per warp
      for (int i = j + 1 + warp; i < n; i += n_warps) {
        const float lij = W[i * ld + j];
        for (int k = j + 1 + lane; k <= i; k += kWarp)
          W[i * ld + k] -= lij * W[k * ld + j];
      }
      __syncthreads();
    }
  }

  // forward: L Y = B
  for (int j = 0; j < n; ++j) {
    const float ljj = W[j * ld + j];
    for (int c = tid; c < nr; c += blockDim.x) Xs[j * nr + c] /= ljj;
    __syncthreads();
    const int m = (n - 1 - j) * nr;
    for (int idx = tid; idx < m; idx += blockDim.x) {
      const int i = j + 1 + idx / nr;
      const int c = idx % nr;
      Xs[i * nr + c] -= W[i * ld + j] * Xs[j * nr + c];
    }
    __syncthreads();
  }
  // backward: L^T X = Y
  for (int j = n - 1; j >= 0; --j) {
    const float ljj = W[j * ld + j];
    for (int c = tid; c < nr; c += blockDim.x) Xs[j * nr + c] /= ljj;
    __syncthreads();
    const int m = j * nr;
    for (int idx = tid; idx < m; idx += blockDim.x) {
      const int i = idx / nr;
      const int c = idx % nr;
      Xs[i * nr + c] -= W[j * ld + i] * Xs[j * nr + c];
    }
    __syncthreads();
  }

  float* x = X + env * n * nr;
  for (int idx = tid; idx < n * nr; idx += blockDim.x) x[idx] = Xs[idx];
  if (L_out != nullptr) {
    float* l = L_out + env * n * n;
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      const int i = idx / n;
      const int k = idx - i * n;
      l[idx] = k <= i ? W[i * ld + k] : 0.0f;
    }
  }
}

int launch(const float* A, const float* B, float* L, float* X, int n_env,
           int n, int nr, bool factor_input, void* stream) {
  const size_t smem = sizeof(float) * (n * (n | 1) + n * nr);
  chol_kernel<<<n_env, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, B, L, X, n, nr, factor_input);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). The Python wrapper checks the sizes: n_env >= 1 and the
// shared memory, 4 (n (n | 1) + n R) bytes, within the 48 KB default.
extern "C" int chol_solve_only(const float* A, const float* B, float* X,
                               int n_env, int n, int nr, void* stream) {
  return launch(A, B, nullptr, X, n_env, n, nr, true, stream);
}

extern "C" int chol_factor_solve(const float* A, const float* B, float* L,
                                 float* X, int n_env, int n, int nr,
                                 void* stream) {
  return launch(A, B, L, X, n_env, n, nr, true, stream);
}

extern "C" int chol_apply(const float* L, const float* B, float* X,
                          int n_env, int n, int nr, void* stream) {
  return launch(L, B, nullptr, X, n_env, n, nr, false, stream);
}
