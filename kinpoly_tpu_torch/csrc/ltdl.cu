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
// Neither reaches that: each env's solve is a chain of 2 x 1146 dependent
// multiply-adds per column, so latency and shared-memory traffic bound a
// kernel that gives each env a few threads.
//
// Design. The TPU kernels keep the env batch on the 128 lanes and run the
// elimination as straight-line code. Here each env's rows are staged in
// shared memory, loaded with coalesced transactions from the engine's
// batch-leading layout, so no transpose is needed.
// K1: one warp owns one env, four envs per block, one wave of ~16 warps
// per SM at N = 2048. The dofs must be in depth-first preorder; they are
// eliminated in descending index order, and lane t keeps in registers the
// pending packed row of the current dof's ancestor at depth t (a path
// stack: from one dof to the next, the lanes of the shared ancestors keep
// their rows and the rest load input rows from shared memory, ~5 times per
// env on a humanoid, once per leaf). Eliminating dof j at depth d, lane d
// has j's finished row: it floors the pivot at reg * max(|M_jj|, 1) of
// the INPUT diagonal and publishes the row to a shared buffer; every lane
// takes one reciprocal (no IEEE division) and lane t < d subtracts
// L_t * row[s] from its own row, four slots per 16-byte broadcast read: a
// dof's d(d+1)/2 updates are d independent FMAs per lane, with no
// read-modify-write of shared memory. Between two row loads the dofs form
// a chain (each the parent of the one before): one straight run of code
// entered at its first depth, every slot index a constant, so a dof costs
// a few dozen instructions plus d FMAs and no table loads. The block's
// rows come in and go out in single coalesced sweeps of 16-byte copies.
// What bounds it (measured, PERF.md): the warps' chains of ~75 dofs
// (publish, warp barrier, broadcast read, reciprocal, FMAs) contend for
// the instruction throughput of the SMSPs, ~4 warps each: at a quarter of
// the envs the kernel takes about half as long, and two envs per warp
// (more independent work per warp) ran slower. The two sweeps, which
// every block of the one wave makes at once, do not overlap the
// elimination. Disjoint subtrees are not run at once, for the same reason:
// the SMSPs have no idle cycles to give them.
// K2: the dofs are in depth-first preorder, so a dof's subtree is a range
// of indices after it, and both passes run over those ranges. Each block
// derives the subtree ends and column offsets from the depth table. An
// env's packed rows are copied once into shared memory, live slots only
// (t <= depth, with cp.async: every copy in flight at once), and the
// pivots are taken as reciprocals, which the pass multiplies by, as the TPU
// kernel does.
// With R > 1 columns, the rows are rearranged on chip into columns of L
// (4.9 KB, 16-byte aligned) and one thread owns a pair of columns: all
// columns run at once, 32 threads per env at R = 55, four envs per block,
// dynamic shared memory up to 227 KB. Pass 1 is in pull form, each dof
// summing over its subtree with independent loads (L four at a time);
// pass 3 in push form, each final x_j updating its subtree. Shared-memory
// traffic on x bounds these passes, so an even dof and its next dof, where
// that is its child (nearly every pair in a humanoid's chains), run as one
// unit: each row below the child is read (and in pass 3 written) once for
// both columns of L.
// With R = 1, one warp owns one env and its lanes go over a subtree,
// reading L from the packed rows: pass 1 is one warp sum per dof and pass 3
// one parallel update per dof, nv steps each instead of ~1146 sequential
// ones.
// Measured on an H100 (PERF.md): the IEEE division's branch to its
// slow path, and its convergence barrier, cost more than the arithmetic in
// such chains; the pass divides nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr size_t kMaxSmem = 232448;        // 227 KB, a block's most on sm_90
constexpr int kSolveWarps = 4;             // K2, R = 1: envs per block
constexpr int kColThreads = 128;           // K2, R > 1: threads per block
constexpr int kMaxColsPerEnv = 256;        // K2, R > 1: threads per env at most
                                           // (one per column pair)

// ---------------------------------------------------------------------------
// K2: the solve. The dofs are in depth-first preorder (the wrapper checks
// it), so the subtree of dof j is the index range (j, end[j]), end[j] being
// the first k > j with depth[k] <= depth[j], and every dof's descendants
// have larger indices than it. Column j of L below the diagonal is
// L[k][depth j] for k in that range; the kernels stage it contiguously at
// col[ptr[j] + k - j - 1], each column starting on a 16-byte boundary, and
// the pivots at dg[k].

// 4-byte asynchronous copy from device to shared memory: the copies of a
// thread are all in flight at once, and cp_async_wait() waits for them.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Barrier of the `count` threads of one env (named barrier id, 1..15), so
// the envs of a block run apart.
__device__ __forceinline__ void env_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}



// Tables every block derives in shared memory from `depth` alone: the
// threads find the subtree ends (four depths per step), then the first
// warp turns the padded column lengths into offsets with a warp scan.
__device__ void build_solve_tables(const int* __restrict__ depth, int nv,
                                   int* s_depth, int* s_end, int* s_ptr) {
  for (int k = threadIdx.x; k < nv; k += blockDim.x) s_depth[k] = depth[k];
  __syncthreads();
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    const int dj = s_depth[j];
    int e = j + 1;
    for (; e + 4 <= nv; e += 4) {
      const int a0 = s_depth[e], a1 = s_depth[e + 1];
      const int a2 = s_depth[e + 2], a3 = s_depth[e + 3];
      if (a0 <= dj) break;
      if (a1 <= dj) { e += 1; break; }
      if (a2 <= dj) { e += 2; break; }
      if (a3 <= dj) { e += 3; break; }
    }
    if (e + 4 > nv)
      while (e < nv && s_depth[e] > dj) ++e;
    s_end[j] = e;
  }
  __syncthreads();
  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int j0 = 0; j0 < nv; j0 += kWarp) {
      const int j = j0 + lane;
      const int m = j < nv ? round4(s_end[j] - j - 1) : 0;
      int incl = m;
      for (int o = 1; o < kWarp; o *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (j < nv) s_ptr[j] = carry + incl - m;
      carry += __shfl_sync(0xffffffffu, incl, kWarp - 1);
    }
  }
  __syncthreads();
}

// Copy one env's packed factor into shared memory: the live slots only
// (t <= depth[k]), padding-only sectors are never fetched, and the reads of
// a warp are contiguous.
__device__ void copy_packed(const float* __restrict__ src, const int* s_depth,
                            int nv, int dp1, int tid, int nthreads,
                            float* tmp) {
  for (int k = 0; k < nv; ++k) {
    const int d = s_depth[k];
    for (int t = tid; t <= d; t += nthreads)
      cp_async4(tmp + k * dp1 + t, src + k * dp1 + t);
  }
}

// Rearrange a shared copy of the packed rows into the column layout above,
// with the reciprocal pivots 1 / D[k] in dg (the TPU kernel multiplies by
// them too).
__device__ void stage_columns(const float* tmp, const int* s_depth,
                              const int* s_end, const int* s_ptr, int nv,
                              int dp1, int tid, int nthreads, float* col,
                              float* dg) {
  for (int j = 0; j < nv; ++j) {
    const int m = s_end[j] - j - 1;
    const float* tj = tmp + (j + 1) * dp1 + s_depth[j];
    float* cj = col + s_ptr[j];
    for (int i = tid; i < m; i += nthreads) cj[i] = tj[i * dp1];
  }
  for (int k = tid; k < nv; k += nthreads) dg[k] = 1.0f / tmp[k * dp1 + s_depth[k]];
}

// The passes of the R > 1 kernel on one thread's pair of columns x2 (row
// stride np float2s). Column j of L is lj[i] = L[j + 1 + i][depth j],
// 16-byte aligned; rows are read four at a time.

// y_j -= sum over i < m of lj[i] y_{j+1+i}
__device__ __forceinline__ void pull_one(float2* x2, int np, int p, int j,
                                         const float* lj, int m) {
  const float4* l4 = reinterpret_cast<const float4*>(lj);
  const float2* xr = x2 + (j + 1) * np + p;
  float2 acc = x2[j * np + p];
  int i = 0;
  for (; i + 4 <= m; i += 4, xr += 4 * np) {
    const float4 l = l4[i / 4];
    const float2 y0 = xr[0], y1 = xr[np], y2 = xr[2 * np], y3 = xr[3 * np];
    acc.x -= l.x * y0.x;
    acc.y -= l.x * y0.y;
    acc.x -= l.y * y1.x;
    acc.y -= l.y * y1.y;
    acc.x -= l.z * y2.x;
    acc.y -= l.z * y2.y;
    acc.x -= l.w * y3.x;
    acc.y -= l.w * y3.y;
  }
  for (; i < m; ++i, xr += np) {
    acc.x -= lj[i] * xr[0].x;
    acc.y -= lj[i] * xr[0].y;
  }
  x2[j * np + p] = acc;
}

// Dofs a and b = a + 1, b a child of a; a's subtree has ma rows, b's mb.
// One pass over b's subtree serves both sums: there L[k][depth a] is
// la[k - a - 1], one float off b's alignment, so a rolling pair of
// aligned loads provides it.
__device__ __forceinline__ void pull_pair(float2* x2, int np, int p, int a,
                                          const float* la, const float* lb,
                                          int ma, int mb) {
  const int b = a + 1;
  const float4* la4 = reinterpret_cast<const float4*>(la);
  const float4* lb4 = reinterpret_cast<const float4*>(lb);
  const float2* xr = x2 + (b + 1) * np + p;
  float2 acca = x2[a * np + p], accb = x2[b * np + p];
  int i = 0;
  float4 lo = la4[0];
  for (; i + 4 <= mb; i += 4, xr += 4 * np) {
    const float4 hi = la4[i / 4 + 1];
    const float4 l = lb4[i / 4];
    const float2 y0 = xr[0], y1 = xr[np], y2 = xr[2 * np], y3 = xr[3 * np];
    accb.x -= l.x * y0.x;
    accb.y -= l.x * y0.y;
    acca.x -= lo.y * y0.x;
    acca.y -= lo.y * y0.y;
    accb.x -= l.y * y1.x;
    accb.y -= l.y * y1.y;
    acca.x -= lo.z * y1.x;
    acca.y -= lo.z * y1.y;
    accb.x -= l.z * y2.x;
    accb.y -= l.z * y2.y;
    acca.x -= lo.w * y2.x;
    acca.y -= lo.w * y2.y;
    accb.x -= l.w * y3.x;
    accb.y -= l.w * y3.y;
    acca.x -= hi.x * y3.x;
    acca.y -= hi.x * y3.y;
    lo = hi;
  }
  for (; i < mb; ++i, xr += np) {
    accb.x -= lb[i] * xr[0].x;
    accb.y -= lb[i] * xr[0].y;
    acca.x -= la[i + 1] * xr[0].x;
    acca.y -= la[i + 1] * xr[0].y;
  }
  x2[b * np + p] = accb;
  // b itself, then the rest of a's subtree (its other children's)
  acca.x -= la[0] * accb.x;
  acca.y -= la[0] * accb.y;
  for (int t = mb + 1; t < ma; ++t) {
    const float2 y = x2[(a + 1 + t) * np + p];
    acca.x -= la[t] * y.x;
    acca.y -= la[t] * y.y;
  }
  x2[a * np + p] = acca;
}

// y_{j+1+i} -= lj[i] x_j for i < m; four rows are read before any is
// written (they are distinct rows)
__device__ __forceinline__ void push_one(float2* x2, int np, int p, int j,
                                         const float* lj, int m) {
  const float4* l4 = reinterpret_cast<const float4*>(lj);
  float2* xr = x2 + (j + 1) * np + p;
  const float2 xj = x2[j * np + p];
  int i = 0;
  for (; i + 4 <= m; i += 4, xr += 4 * np) {
    const float4 l = l4[i / 4];
    float2 y0 = xr[0], y1 = xr[np], y2 = xr[2 * np], y3 = xr[3 * np];
    y0.x -= l.x * xj.x;
    y0.y -= l.x * xj.y;
    y1.x -= l.y * xj.x;
    y1.y -= l.y * xj.y;
    y2.x -= l.z * xj.x;
    y2.y -= l.z * xj.y;
    y3.x -= l.w * xj.x;
    y3.y -= l.w * xj.y;
    xr[0] = y0;
    xr[np] = y1;
    xr[2 * np] = y2;
    xr[3 * np] = y3;
  }
  for (; i < m; ++i, xr += np) {
    float2 y = xr[0];
    y.x -= lj[i] * xj.x;
    y.y -= lj[i] * xj.y;
    xr[0] = y;
  }
}

// The same units as pull_pair: x_b loses L[b][depth a] x_a, then one pass
// over b's subtree takes both pushes, then x_a goes to the rest of a's.
__device__ __forceinline__ void push_pair(float2* x2, int np, int p, int a,
                                          const float* la, const float* lb,
                                          int ma, int mb) {
  const int b = a + 1;
  const float4* la4 = reinterpret_cast<const float4*>(la);
  const float4* lb4 = reinterpret_cast<const float4*>(lb);
  const float2 xa = x2[a * np + p];
  float2 xb = x2[b * np + p];
  xb.x -= la[0] * xa.x;
  xb.y -= la[0] * xa.y;
  x2[b * np + p] = xb;
  float2* xr = x2 + (b + 1) * np + p;
  int i = 0;
  float4 lo = la4[0];
  for (; i + 4 <= mb; i += 4, xr += 4 * np) {
    const float4 hi = la4[i / 4 + 1];
    const float4 l = lb4[i / 4];
    float2 y0 = xr[0], y1 = xr[np], y2 = xr[2 * np], y3 = xr[3 * np];
    y0.x -= lo.y * xa.x;
    y0.y -= lo.y * xa.y;
    y0.x -= l.x * xb.x;
    y0.y -= l.x * xb.y;
    y1.x -= lo.z * xa.x;
    y1.y -= lo.z * xa.y;
    y1.x -= l.y * xb.x;
    y1.y -= l.y * xb.y;
    y2.x -= lo.w * xa.x;
    y2.y -= lo.w * xa.y;
    y2.x -= l.z * xb.x;
    y2.y -= l.z * xb.y;
    y3.x -= hi.x * xa.x;
    y3.y -= hi.x * xa.y;
    y3.x -= l.w * xb.x;
    y3.y -= l.w * xb.y;
    xr[0] = y0;
    xr[np] = y1;
    xr[2 * np] = y2;
    xr[3 * np] = y3;
    lo = hi;
  }
  for (; i < mb; ++i, xr += np) {
    float2 y = xr[0];
    y.x -= la[i + 1] * xa.x;
    y.y -= la[i + 1] * xa.y;
    y.x -= lb[i] * xb.x;
    y.y -= lb[i] * xb.y;
    xr[0] = y;
  }
  for (int t = mb + 1; t < ma; ++t) {
    float2 y = x2[(a + 1 + t) * np + p];
    y.x -= la[t] * xa.x;
    y.y -= la[t] * xa.y;
    x2[(a + 1 + t) * np + p] = y;
  }
}

// R > 1: one thread per pair of right-hand-side columns (pairs >= tpe
// apart go to one thread in turn), tpe threads per env, several envs per
// block. The columns sit in shared memory at an even row stride xs, so a
// pair is one 8-byte access; each column is solved by its own thread.
__global__ void ltdl_solve_cols_kernel(const float* __restrict__ Rf,
                                       const float* __restrict__ B,
                                       float* __restrict__ X,
                                       const int* __restrict__ depth,
                                       int n, int nv, int dp1, int nr,
                                       int tpe, int n_col_max) {
  extern __shared__ float smem[];
  int* s_depth = reinterpret_cast<int*>(smem);
  int* s_end = s_depth + nv;
  int* s_ptr = s_end + nv;
  build_solve_tables(depth, nv, s_depth, s_end, s_ptr);
  const int xs = (nr + 1) & ~1;
  const int np = xs / 2;
  const int e = threadIdx.x / tpe;
  const int c0 = threadIdx.x - e * tpe;
  const int env = blockIdx.x * (blockDim.x / tpe) + e;
  const int xsz = nv * (xs > dp1 ? xs : dp1);
  float* col = smem + round4(3 * nv) + e * (n_col_max + round4(nv) + round4(xsz));
  float* dg = col + n_col_max;
  float* x = dg + round4(nv);
  if (env >= n) return;  // only the env's own barriers follow
  const float* b = B + static_cast<size_t>(env) * nv * nr;
  // the packed rows pass through the right-hand-side region
  copy_packed(Rf + static_cast<size_t>(env) * nv * dp1, s_depth, nv, dp1, c0,
              tpe, x);
  cp_async_wait();
  env_sync(1 + e, tpe);
  stage_columns(x, s_depth, s_end, s_ptr, nv, dp1, c0, tpe, col, dg);
  env_sync(1 + e, tpe);
  // each thread loads and solves its own pair of columns
  for (int p = c0; p < np; p += tpe)
    for (int k = 0; k < nv; ++k) {
      cp_async4(x + k * xs + 2 * p, b + k * nr + 2 * p);
      if (2 * p + 1 < nr) cp_async4(x + k * xs + 2 * p + 1, b + k * nr + 2 * p + 1);
      else x[k * xs + 2 * p + 1] = 0.0f;  // padding column
    }
  cp_async_wait();
  float* xo = X + static_cast<size_t>(env) * nv * nr;
  float2* x2 = reinterpret_cast<float2*>(x);
  for (int p = c0; p < np; p += tpe) {
    // pass 1, L^T y = b in pull form, descending: y_j = b_j - sum over the
    // subtree of L[k][depth j] y_k. An even dof j whose next dof is its
    // child runs as one unit with it, so each row below the child is read
    // once for both sums.
    for (int j = nv - 1; j >= 0;) {
      if (j % 2 == 1 && s_depth[j] > s_depth[j - 1]) {
        pull_pair(x2, np, p, j - 1, col + s_ptr[j - 1], col + s_ptr[j],
                  s_end[j - 1] - j, s_end[j] - j - 1);
        j -= 2;
      } else {
        pull_one(x2, np, p, j, col + s_ptr[j], s_end[j] - j - 1);
        j -= 1;
      }
    }
    // pass 2: D^-1 (dg holds the reciprocals)
    for (int k = 0; k < nv; ++k) {
      float2 z = x2[k * np + p];
      z.x *= dg[k];
      z.y *= dg[k];
      x2[k * np + p] = z;
    }
    // pass 3, L x = z in push form, ascending: once x_j is final (its
    // ancestors have smaller indices), each dof k of its subtree loses
    // L[k][depth j] x_j; the same units as pass 1
    for (int j = 0; j < nv;) {
      if (j % 2 == 0 && j + 1 < nv && s_depth[j + 1] > s_depth[j]) {
        push_pair(x2, np, p, j, col + s_ptr[j], col + s_ptr[j + 1],
                  s_end[j] - j - 1, s_end[j + 1] - j - 2);
        j += 2;
      } else {
        push_one(x2, np, p, j, col + s_ptr[j], s_end[j] - j - 1);
        j += 1;
      }
    }
    for (int k = 0; k < nv; ++k) {
      xo[k * nr + 2 * p] = x[k * xs + 2 * p];
      if (2 * p + 1 < nr) xo[k * nr + 2 * p + 1] = x[k * xs + 2 * p + 1];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// R = 1: one warp per env, the lanes over a dof's subtree, reading L[k][t]
// straight from the env's packed rows in shared memory. Pass 1 is one warp
// sum per dof, pass 3 one parallel update per dof: nv steps each.
__global__ void ltdl_solve_vec_kernel(const float* __restrict__ Rf,
                                      const float* __restrict__ B,
                                      float* __restrict__ X,
                                      const int* __restrict__ depth,
                                      int n, int nv, int dp1) {
  extern __shared__ float smem[];
  int* s_depth = reinterpret_cast<int*>(smem);
  int* s_end = s_depth + nv;
  int* s_ptr = s_end + nv;
  build_solve_tables(depth, nv, s_depth, s_end, s_ptr);
  const int lane = threadIdx.x % kWarp;
  const int wib = threadIdx.x / kWarp;
  const int env = blockIdx.x * (blockDim.x / kWarp) + wib;
  if (env >= n) return;  // only warp barriers follow
  float* r = smem + round4(3 * nv) + wib * (round4(nv * dp1) + round4(2 * nv));
  float* dg = r + round4(nv * dp1);
  float* x = dg + nv;
  copy_packed(Rf + static_cast<size_t>(env) * nv * dp1, s_depth, nv, dp1, lane,
              kWarp, r);
  const float* b = B + static_cast<size_t>(env) * nv;
  for (int k = lane; k < nv; k += kWarp) cp_async4(x + k, b + k);
  cp_async_wait();
  __syncwarp();
  for (int k = lane; k < nv; k += kWarp) dg[k] = 1.0f / r[k * dp1 + s_depth[k]];
  // pass 1, pull form: y_j -= sum over the subtree of L[k][depth j] y_k
  for (int j = nv - 1; j >= 0; --j) {
    const int m = s_end[j] - j - 1;
    if (m == 0) continue;
    const float* lj = r + (j + 1) * dp1 + s_depth[j];
    float s = 0.0f;
    for (int i = lane; i < m; i += kWarp) s += lj[i * dp1] * x[j + 1 + i];
    s = warp_sum(s);
    if (lane == 0) x[j] -= s;
    __syncwarp();
  }
  // pass 2: D^-1 (dg holds the reciprocals)
  for (int k = lane; k < nv; k += kWarp) x[k] *= dg[k];
  __syncwarp();
  // pass 3, push form: each final x_j updates its subtree
  for (int j = 0; j < nv; ++j) {
    const int m = s_end[j] - j - 1;
    if (m == 0) continue;
    const float* lj = r + (j + 1) * dp1 + s_depth[j];
    const float xj = x[j];
    for (int i = lane; i < m; i += kWarp) x[j + 1 + i] -= lj[i * dp1] * xj;
    __syncwarp();
  }
  float* xo = X + static_cast<size_t>(env) * nv;
  for (int k = lane; k < nv; k += kWarp) xo[k] = x[k];
}

// ---------------------------------------------------------------------------
// K1: the factor. The dofs are in depth-first preorder (the wrapper checks
// it) and are eliminated in descending index order, so a dof's subtree is
// done before it. Lane t of an env's warp holds in registers acc, the
// pending packed row of the current dof's ancestor at depth t (slots
// s <= t; the slots above are scratch that is never read), and dminl, the
// pivot floor reg * max(|M_kk|, 1) from that row's INPUT diagonal. In
// preorder every ancestor of dof j + 1 above its own depth is an ancestor
// of j too, so going from j + 1 to j keeps lanes t < lo = min(depth[j + 1],
// depth[j] + 1), and lanes lo .. depth[j] load the input rows of j's new
// path from shared memory. Between two such loads the dofs form a chain,
// each the parent of the one before, at depths d, d - 1, ...: one straight
// run of code, entered at depth d, with every slot index a compile-time
// constant.

// 1 / x for a pivot x: the reciprocal estimate and one Newton step (within
// an ulp of 1 / x), without the IEEE division's range check and its branch
// to the slow path. The pivots are floored at reg * max(|M_kk|, 1) >= reg
// before they are inverted, so x is never zero, denormal or negative.
__device__ __forceinline__ float rcp_pivot(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// 16-byte asynchronous copy from device to shared memory (both aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

constexpr int kFactorWarps = 4;  // envs per block: 512 blocks at N = 2048,
                                 // one wave of ~16 warps per SM

// Eliminate the dof j at depth D, whose finished row lane D holds: lane D
// floors its pivot and publishes the row through b (16-byte stores), every
// lane takes its L_t = row[t] / pivot, lanes t < D subtract L_t row[s] for
// s < D from their rows (16-byte broadcast reads, D independent FMAs), and
// L and the pivot overwrite the input row of j in shared memory (mj): no
// later dof reads it, as the rows loaded later are ancestors'.
template <int D>
__device__ __forceinline__ void eliminate(float (&acc)[kWarp], float dminl,
                                          float* b, float* mj, int lane) {
  constexpr int kPub = (D + 4) / 4;   // float4s holding slots 0..D
  constexpr int kUpd = (D + 3) / 4;   // float4s holding slots 0..D-1
  if (lane == D) {
    acc[D] = fmaxf(acc[D], dminl);
#pragma unroll
    for (int q = 0; q < kPub; ++q)
      reinterpret_cast<float4*>(b)[q] =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncwarp();
  const float piv = b[D];
  const float L = b[lane] * rcp_pivot(piv);
  float4 v[kUpd > 0 ? kUpd : 1];
#pragma unroll
  for (int q = 0; q < kUpd; ++q) v[q] = reinterpret_cast<const float4*>(b)[q];
  if (lane <= D) mj[lane] = lane < D ? L : piv;
#pragma unroll
  for (int q = 0; q < kUpd; ++q) {
    acc[4 * q] = fmaf(-L, v[q].x, acc[4 * q]);
    if (4 * q + 1 < D) acc[4 * q + 1] = fmaf(-L, v[q].y, acc[4 * q + 1]);
    if (4 * q + 2 < D) acc[4 * q + 2] = fmaf(-L, v[q].z, acc[4 * q + 2]);
    if (4 * q + 3 < D) acc[4 * q + 3] = fmaf(-L, v[q].w, acc[4 * q + 3]);
  }
}

// One dof of a chain, then on to its parent at depth D - 1 while `run`
// says the chain goes on. The broadcast buffer alternates, so one warp
// barrier per dof orders a publish after the reads of the one before.
#define K1_STEP(D)                                                      \
  case D:                                                               \
    eliminate<D>(acc, dminl, buf + (j & 1) * kWarp, m + j * dp1, lane); \
    d = D;                                                              \
    --j;                                                                \
    if (run-- == 0) break;                                              \
    [[fallthrough]];

__global__ void __launch_bounds__(kFactorWarps * kWarp)
ltdl_factor_kernel(const float* __restrict__ R, float* __restrict__ out,
                   const int* __restrict__ anc, const int* __restrict__ depth,
                   int n, int nv, int dp1, float reg) {
  extern __shared__ float smem[];
  const int sz = nv * dp1;
  int* s_depth = reinterpret_cast<int*>(smem);
  int* s_anc = s_depth + round4(nv);
  const int lane = threadIdx.x % kWarp;
  const int wib = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  const int env0 = blockIdx.x * wpb;
  const int nenv = min(wpb, n - env0);
  // two broadcast rows per warp, then the block's envs' rows, contiguous
  // as in R (16-byte aligned)
  float* buf = smem + round4(nv) + round4(sz) + wib * 2 * kWarp;
  float* rows = smem + round4(nv) + round4(sz) + wpb * 2 * kWarp;
  float* m = rows + wib * sz;
  const size_t g0 = static_cast<size_t>(env0) * sz;
  const int total = nenv * sz;
  const bool vec = ((reinterpret_cast<size_t>(R + g0) |
                     reinterpret_cast<size_t>(out + g0)) & 15) == 0;
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    cp_async4(reinterpret_cast<float*>(s_depth + i),
              reinterpret_cast<const float*>(depth + i));
  for (int i = threadIdx.x; i < sz; i += blockDim.x)
    cp_async4(reinterpret_cast<float*>(s_anc + i),
              reinterpret_cast<const float*>(anc + i));
  // the block's rows in one coalesced sweep of 16-byte copies, padding
  // included: the padding has to reach the output anyway, and copying the
  // live slots alone, row by row, measured slower (PERF.md)
  const int body = vec ? total & ~3 : 0;
  for (int i = 4 * threadIdx.x; i < body; i += 4 * blockDim.x)
    cp_async16(rows + i, R + g0 + i);
  for (int i = body + threadIdx.x; i < total; i += blockDim.x)
    cp_async4(rows + i, R + g0 + i);
  buf[lane] = 0.0f;
  buf[kWarp + lane] = 0.0f;
  cp_async_wait();
  __syncthreads();
  if (wib < nenv) {
    float acc[kWarp];
#pragma unroll
    for (int s = 0; s < kWarp; ++s) acc[s] = 0.0f;
    float dminl = 0.0f;
    int j = nv - 1;
    int lo = 0;
    while (j >= 0) {
      int d = s_depth[j];
      if (lane >= lo && lane <= d) {
        const float* row = m + s_anc[j * dp1 + lane] * dp1;  // anc[j][d] = j
#pragma unroll
        for (int s = 0; s < kWarp; ++s) acc[s] = s <= lane ? row[s] : 0.0f;
        dminl = reg * fmaxf(fabsf(row[lane]), 1.0f);
      }
      // the chain's length: lane i checks that dof j - 1 - i is the parent
      // of dof j - i, and the first failure ends it
      const int k = j - 1 - lane;
      const bool link = lane < d && k >= 0 && s_depth[k > 0 ? k : 0] == d - 1 - lane;
      int run = __ffs(~__ballot_sync(0xffffffffu, link)) - 1;
      switch (d) {
        K1_STEP(31) K1_STEP(30) K1_STEP(29) K1_STEP(28) K1_STEP(27)
        K1_STEP(26) K1_STEP(25) K1_STEP(24) K1_STEP(23) K1_STEP(22)
        K1_STEP(21) K1_STEP(20) K1_STEP(19) K1_STEP(18) K1_STEP(17)
        K1_STEP(16) K1_STEP(15) K1_STEP(14) K1_STEP(13) K1_STEP(12)
        K1_STEP(11) K1_STEP(10) K1_STEP(9) K1_STEP(8) K1_STEP(7)
        K1_STEP(6) K1_STEP(5) K1_STEP(4) K1_STEP(3) K1_STEP(2)
        K1_STEP(1) K1_STEP(0)
      }
      if (j >= 0) lo = min(d, s_depth[j] + 1);
    }
  }
  // the factor, padding untouched, out in one coalesced sweep
  __syncthreads();
  float* dst = out + g0;
  for (int i = 4 * threadIdx.x; i < body; i += 4 * blockDim.x)
    *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(rows + i);
  for (int i = body + threadIdx.x; i < total; i += blockDim.x) dst[i] = rows[i];
}

#undef K1_STEP

// The launcher cannot read `depth` (device memory), so it sizes the column
// store for the most a preorder tree of this size can hold: depth[k] <=
// min(k, dp1 - 1) slots in all, plus up to 3 floats of alignment for each
// column, rounded to 16 bytes.
int col_bound(int nv, int dp1) {
  int m = 0;
  for (int k = 0; k < nv; ++k) m += k < dp1 - 1 ? k : dp1 - 1;
  return (m + 3 * nv + 3) & ~3;
}

void allow_large_smem(const void* fn) {
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kMaxSmem));
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). Sizes are checked by the Python wrapper: dofs in
// depth-first preorder and one env's shared memory (the block's tables
// included) within a block's 227 KB; for K1 also dp1 <= 32, for K2 the
// column bound below.
extern "C" int ltdl_factor(const float* R, float* out, const int* anc,
                           const int* depth, int n, int nv, int dp1, float reg,
                           void* stream) {
  static const bool once = (allow_large_smem(
      reinterpret_cast<const void*>(ltdl_factor_kernel)), true);
  (void)once;
  const size_t rows = static_cast<size_t>(nv) * dp1;
  const size_t tables = sizeof(int) * (((nv + 3) & ~3) + ((rows + 3) & ~size_t{3}));
  const size_t per_env = sizeof(float) * (rows + 2 * kWarp);
  int w = static_cast<int>((kMaxSmem - tables) / per_env);
  if (w > kFactorWarps) w = kFactorWarps;
  if (w < 1 || dp1 > kWarp) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + w - 1) / w;
  ltdl_factor_kernel<<<blocks, w * kWarp, tables + w * per_env,
                       static_cast<cudaStream_t>(stream)>>>(
      R, out, anc, depth, n, nv, dp1, reg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ltdl_solve(const float* Rf, const float* B, float* X,
                          const int* depth, int n, int nv, int dp1, int nr,
                          void* stream) {
  const int ncm = col_bound(nv, dp1);
  const size_t tables = sizeof(int) * ((3 * nv + 3) & ~3);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nr == 1) {
    static const bool once = (allow_large_smem(
        reinterpret_cast<const void*>(ltdl_solve_vec_kernel)), true);
    (void)once;
    const size_t per_env =
        sizeof(float) * (((2 * nv + 3) & ~3) + ((nv * dp1 + 3) & ~3));
    int w = static_cast<int>((kMaxSmem - tables) / per_env);
    if (w > kSolveWarps) w = kSolveWarps;
    if (w < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (n + w - 1) / w;
    ltdl_solve_vec_kernel<<<blocks, w * kWarp, tables + w * per_env, st>>>(
        Rf, B, X, depth, n, nv, dp1);
  } else {
    static const bool once = (allow_large_smem(
        reinterpret_cast<const void*>(ltdl_solve_cols_kernel)), true);
    (void)once;
    const int np = (nr + 1) / 2;
    int tpe = (np + kWarp - 1) / kWarp * kWarp;
    if (tpe > kMaxColsPerEnv) tpe = kMaxColsPerEnv;
    const size_t per_env =
        sizeof(float) * (ncm + ((nv + 3) & ~3) +
                         ((static_cast<size_t>(nv) * (2 * np > dp1 ? 2 * np : dp1) + 3) & ~3));
    int e = kColThreads / tpe;
    if (e < 1) e = 1;
    const int fit = static_cast<int>((kMaxSmem - tables) / per_env);
    if (e > fit) e = fit;
    if (e < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (n + e - 1) / e;
    ltdl_solve_cols_kernel<<<blocks, e * tpe, tables + e * per_env, st>>>(
        Rf, B, X, depth, n, nv, dp1, nr, tpe, ncm);
  }
  return static_cast<int>(cudaGetLastError());
}
