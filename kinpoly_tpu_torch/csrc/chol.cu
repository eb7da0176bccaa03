// Dense batched Cholesky factor and multi-RHS solve for Hopper (sm_90a):
// K4a chol_solve_only (factor + both triangular solves, factor not
// written), K4b chol_factor_solve (the same kernel, also writing L) and K4c
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
// 3.35 TB/s and float32 at 67 TFLOP/s. Neither is reached (PERF.md): each
// env is a chain of 19 dependent panels, and what bounds the kernel is
// instruction issue at 3-4 warps per SMSP, the reads of A and B (row
// pieces of a few hundred bytes from every env at once), which no compute
// overlaps, and at R = 55 the envs per SM: 6 (7 by shared memory alone),
// so 2048 envs take three waves.
//
// K4a/K4b design. The TPU kernels put 128 envs on the lanes, pad n to 80
// and unroll the column recursion. Here one block of W warps owns one env
// (one warp at R = 1, two at R > 1) and the forward solve is folded into
// the factor: the right-hand sides are extra rows of the matrix being
// factored, [A | B]^T, so the factor of row np + c is y_c = L^-1 b_c.
// Rows are padded to np = n rounded up to 4 (the padding is an identity
// block, whose right-hand sides are 0) and read as 16-byte chunks. The
// rows of A need only their lower triangle, so they are folded in pairs
// into np / 2 physical rows (see Rows below): at R = 1 an env takes
// 13.4 KB and 16 envs share an SM, all 2048 in one wave.
// - Factor and forward solve, left-looking in panels of 4 columns: for
//   panel j0, every row r >= j0 (real and right-hand-side rows alike, a
//   few per thread) sums its 4 panel entries in registers over k < j0,
//   reading its own row and the panel's 4 rows (broadcast) 16 bytes at a
//   time: 16 independent FMAs per 5 shared reads, no read-modify-write of
//   shared memory, the next reads issued before the FMAs. The 4 rows of
//   the diagonal block publish their sums; every thread factors that
//   4 x 4 block (one rsqrt per pivot, no IEEE division or square root),
//   then solves its own rows against it and writes them back. Two
//   barriers of the env's warps per panel (__syncwarp for one warp, a
//   named barrier for two), none per column.
// - Backward solve L^T X = Y, R > 1: each thread owns whole right-hand-side
//   rows and solves them alone, panel by panel from the last, with the
//   panel's 4 entries in registers and the rows of L read by broadcast:
//   no barrier at all.
// - R = 1: one warp; for each panel the lanes split the sum over k, a
//   butterfly adds the four partial sums, and each lane finishes the
//   4 x 4 block.
// - Staging: the lower triangle of A is copied row by row and B by tiles
//   with 4-byte cp.async, every copy of a thread in flight at once (the
//   rows of A are not 16-byte aligned); B goes in transposed and X comes
//   out by 4 x 8 tiles, which hit 32 distinct banks. L (K4b) goes out row
//   by row with explicit zeros above the diagonal.
//
// K4c design: the same pair of solves with L given instead of factored,
// on K4a's parts. L's lower triangle is staged as A is (folded rows,
// identity padding rows, the upper triangle never read) and the pivots
// are the hardware reciprocals of its diagonal, taken once per env (one
// per thread, one barrier); no IEEE division. The forward solve L Y = B
// mirrors the backward one: at R > 1 each thread owns whole right-hand
// sides and sums each panel's 4 entries over k < j0 (panel_sums, as the
// factor does) before solving them against the panel's 4 x 4 block of L,
// with no barrier; at R = 1 one warp splits each panel's sum over the
// 16-byte chunks of k and a butterfly adds the lanes. backward_rows and
// backward_vec then run as in K4a. The shared memory is K4a's, the same
// limit (227 KB: R <= 721 at n = 75), 7 envs per SM at R = 55. Half of
// the time at R = 55 is the staging and X's store (PERF.md); keeping each
// right-hand side in registers instead, with only L in shared memory,
// measured no faster.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr size_t kMaxSmem = 232448;   // 227 KB, a block's most on sm_90

// ---------------------------------------------------------------------------
// K4a / K4b

// Layout of one env in shared memory, in floats. Rows are padded to np (n
// rounded up to 4) and read in 16-byte chunks (columns k..k+3, k % 4 == 0).
// The real rows r < np need columns 0..r only, so they are folded in pairs:
// physical row p < h = np / 2 holds row p forward (chunk k at p SL + k) and
// row np - 1 - p backward by chunk (chunk k at p SL + SL - 4 - k, its
// floats in order); SL >= np + 4 keeps the two apart and SL / 4 odd puts
// eight consecutive rows' chunks in distinct banks. Then come the nr
// right-hand-side rows at the stride Se >= np, Se / 4 odd, the np
// reciprocal pivots and the 4 x 4 diagonal block.
__host__ __device__ __forceinline__ int padded(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int odd_quads(int x) {   // x % 4 == 0
  return (x / 4) % 2 == 1 ? x : x + 4;
}
__host__ __device__ __forceinline__ size_t solve_floats(int n, int nr) {
  const int np = padded(n);
  return static_cast<size_t>(np / 2) * odd_quads(np + 4) +
         static_cast<size_t>(nr) * odd_quads(np) + np + 16;
}

struct Rows {
  float* base;   // physical rows
  float* ext;    // right-hand-side rows
  int np, h, SL, Se;

  __device__ __forceinline__ Rows(float* smem, int n) {
    np = padded(n);
    h = np / 2;
    SL = odd_quads(np + 4);
    Se = odd_quads(np);
    base = smem;
    ext = smem + h * SL;
  }
  // chunk k of row r is at row(r) + dir(r) k
  __device__ __forceinline__ float* row(int r) const {
    return r < h ? base + r * SL : r < np ? base + (np - r) * SL - 4 : ext + (r - np) * Se;
  }
  __device__ __forceinline__ int dir(int r) const { return r < h || r >= np ? 1 : -1; }
  __device__ __forceinline__ float* chunk(int r, int k) const { return row(r) + dir(r) * k; }
  __device__ __forceinline__ float& at(int r, int k) const { return chunk(r, k & ~3)[k & 3]; }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Barrier of the env's W warps (the block holds one env).
template <int W>
__device__ __forceinline__ void env_sync() {
  if constexpr (W == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"r"(W * kWarp) : "memory");
  }
}

// 1 / sqrt(d) for a pivot d: the hardware's estimate (relative error
// below 2^-22), without the IEEE square root's and division's branches to their slow
// paths. A negative pivot (A not SPD) gives NaN, and NaN then fills every
// column after it, as the plain version's sqrt does.
__device__ __forceinline__ float rsqrt_pivot(float d) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// acc -= sum over q of o[q] p_q[c] for the 4 columns k..k+3, in order
__device__ __forceinline__ void sub_quad(float4& acc, float4 o, float4 p0,
                                         float4 p1, float4 p2, float4 p3) {
  acc.x = fmaf(-o.w, p0.w, fmaf(-o.z, p0.z, fmaf(-o.y, p0.y, fmaf(-o.x, p0.x, acc.x))));
  acc.y = fmaf(-o.w, p1.w, fmaf(-o.z, p1.z, fmaf(-o.y, p1.y, fmaf(-o.x, p1.x, acc.y))));
  acc.z = fmaf(-o.w, p2.w, fmaf(-o.z, p2.z, fmaf(-o.y, p2.y, fmaf(-o.x, p2.x, acc.z))));
  acc.w = fmaf(-o.w, p3.w, fmaf(-o.z, p3.z, fmaf(-o.y, p3.y, fmaf(-o.x, p3.x, acc.w))));
}

// 4-byte asynchronous copy from device to shared memory: a thread's copies
// are all in flight at once, and cp_async_wait() waits for them.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows r_lo..r_hi-1 of A's lower triangle into shared memory, where
// element k of row r is at p + (r - r_lo) ps + k (forward rows) or
// p + (r - r_lo) ps - (k & ~3) + (k & 3) (rows stored backward by chunk).
// Lane t copies columns k = k0 + t + T q of each row.
template <int T, int KQ>
__device__ __forceinline__ void stage_rows(const float* __restrict__ a, int n,
                                           int r_lo, int r_hi, float* p, int ps,
                                           bool backward, int t) {
  for (int k0 = 0; k0 < r_hi; k0 += T * KQ) {
    int off[KQ];
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int k = k0 + t + T * q;
      off[q] = backward ? (k & 3) - (k & ~3) : k;
    }
    for (int r = max(r_lo, k0); r < r_hi; ++r) {
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        const int k = k0 + t + T * q;
        if (k <= r) cp_async4(p + (r - r_lo) * ps + off[q], a + r * n + k);
      }
    }
  }
}

// Copy one env in: the lower triangle of A into rows 0..n-1 (the upper
// triangle is not read), the identity into the padding rows n..np-1, and
// B transposed into rows np..np+nr-1 with zeros in its padding columns.
// The copies go with cp.async, each thread's all in flight at once.
template <int W>
__device__ __forceinline__ void stage(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      const Rows& R, int n, int nr, int t) {
  constexpr int T = W * kWarp;
  constexpr int KQ = W == 1 ? 3 : 2;   // columns per lane at n <= 96
  stage_rows<T, KQ>(a, n, 0, min(n, R.h), R.base, R.SL, false, t);
  stage_rows<T, KQ>(a, n, R.h, n, R.row(R.h), -R.SL, true, t);
  for (int r = n; r < R.np; ++r)
    for (int k = t; k <= r; k += T) R.at(r, k) = k == r ? 1.0f : 0.0f;
  // B: a warp moves tiles of 4 of its rows j by 8 columns c; in shared
  // memory (row np + c, column j) a tile's 32 addresses fall in 32 banks
  const int lane = t % kWarp;
  const int jl = lane & 3;
  for (int c = (t / kWarp) * 8 + (lane >> 2); c - (lane >> 2) < nr; c += 8 * W) {
    if (c >= nr) continue;
    const float* src = b + jl * nr + c;
    float* dst = R.ext + c * R.Se + jl;
    for (int j = 0; j + jl < R.np; j += 4) {
      if (j + jl < n) cp_async4(dst + j, src + j * nr);
      else dst[j] = 0.0f;
    }
  }
}

// A row of the factor pass, as a thread sees it: chunk k at p + d k.
struct RowRef {
  float* p;
  int d;
};

// Sums of NS rows per thread over the columns k < j0 of the panel's rows
// q[0..3]: acc[m].c -= sum_k own[m][k] q_c[k], k ascending. The next
// k-quad's reads are issued before this one's FMAs; the last reads the
// panel's own columns, unused.
template <int NS, int MS>
__device__ __forceinline__ void panel_sums(float4 (&acc)[MS],
                                           const RowRef (&own)[MS],
                                           const RowRef (&q)[4], int j0) {
  if (j0 == 0) return;
  float4 q0 = ld4(q[0].p), q1 = ld4(q[1].p), q2 = ld4(q[2].p), q3 = ld4(q[3].p);
  float4 o[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) o[m] = ld4(own[m].p);
  for (int k = 4; k <= j0; k += 4) {
    const float4 n0 = ld4(q[0].p + q[0].d * k), n1 = ld4(q[1].p + q[1].d * k);
    const float4 n2 = ld4(q[2].p + q[2].d * k), n3 = ld4(q[3].p + q[3].d * k);
    float4 on[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) on[m] = ld4(own[m].p + own[m].d * k);
#pragma unroll
    for (int m = 0; m < NS; ++m) sub_quad(acc[m], o[m], q0, q1, q2, q3);
    q0 = n0;
    q1 = n1;
    q2 = n2;
    q3 = n3;
#pragma unroll
    for (int m = 0; m < NS; ++m) o[m] = on[m];
  }
}

// Factor and forward solve. Rows j0.. of panel j0 are spread over the
// threads, MS per thread at a time (row r0 + t + T m, the last row
// repeated where a group runs past nrow, its results dropped); the first
// group holds the diagonal block in threads 0..3, slot 0.
template <int W>
__device__ __forceinline__ void factor_forward(const Rows& R, float* rinv,
                                               float* dg, int nrow, int t) {
  constexpr int T = W * kWarp;
  constexpr int MS = 4 / W;
  for (int j0 = 0; j0 < R.np; j0 += 4) {
    const RowRef q[4] = {{R.row(j0), R.dir(j0)}, {R.row(j0 + 1), R.dir(j0 + 1)},
                         {R.row(j0 + 2), R.dir(j0 + 2)}, {R.row(j0 + 3), R.dir(j0 + 3)}};
    float l10 = 0.f, l20 = 0.f, l21 = 0.f, l30 = 0.f, l31 = 0.f, l32 = 0.f;
    float4 rv = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = j0; r0 < nrow; r0 += T * MS) {
      RowRef own[MS];
      float4 acc[MS];
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        const int r = min(r0 + t + T * m, nrow - 1);
        own[m] = {R.row(r), R.dir(r)};
        acc[m] = ld4(own[m].p + own[m].d * j0);
      }
      // the slots with a row in them, the same for every thread
      const int ns = (nrow - r0 + T - 1) / T;
      if (ns == 1 || MS == 1) {
        panel_sums<1>(acc, own, q, j0);
      } else if (ns == 2 || MS == 2) {
        panel_sums<(MS > 1 ? 2 : 1)>(acc, own, q, j0);
      } else if (ns == 3) {
        panel_sums<(MS > 2 ? 3 : 1)>(acc, own, q, j0);
      } else {
        panel_sums<MS>(acc, own, q, j0);
      }
      if (r0 == j0) {
        // the 4 x 4 diagonal block, factored by every thread alike
        if (t < 4) st4(dg + 4 * t, acc[0]);
        env_sync<W>();
        const float4 d0 = ld4(dg), d1 = ld4(dg + 4), d2 = ld4(dg + 8),
                     d3 = ld4(dg + 12);
        rv.x = rsqrt_pivot(d0.x);
        l10 = d1.x * rv.x;
        rv.y = rsqrt_pivot(fmaf(-l10, l10, d1.y));
        l20 = d2.x * rv.x;
        l21 = fmaf(-l20, l10, d2.y) * rv.y;
        rv.z = rsqrt_pivot(fmaf(-l21, l21, fmaf(-l20, l20, d2.z)));
        l30 = d3.x * rv.x;
        l31 = fmaf(-l30, l10, d3.y) * rv.y;
        l32 = fmaf(-l31, l21, fmaf(-l30, l20, d3.z)) * rv.z;
        rv.w = rsqrt_pivot(fmaf(-l32, l32, fmaf(-l31, l31, fmaf(-l30, l30, d3.w))));
        if (t == 0) st4(rinv + j0, rv);
      }
      // each row against the block: on the diagonal rows this gives the
      // block's own L (d * rsqrt(d) on the diagonal), zeros above it
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        const int r = r0 + t + T * m;
        if (r < nrow) {
          const float4 a = acc[m];
          float4 l;
          l.x = a.x * rv.x;
          l.y = fmaf(-l.x, l10, a.y) * rv.y;
          l.z = fmaf(-l.y, l21, fmaf(-l.x, l20, a.z)) * rv.z;
          l.w = fmaf(-l.z, l32, fmaf(-l.y, l31, fmaf(-l.x, l30, a.w))) * rv.w;
          const int c0 = r - j0;
          if (c0 < 3) {
            l.w = 0.f;
            if (c0 < 2) l.z = 0.f;
            if (c0 < 1) l.y = 0.f;
          }
          st4(own[m].p + own[m].d * j0, l);
        }
      }
    }
    env_sync<W>();
  }
}

// Chunk i0 of rows k..k+3 (k % 4 == 0) of L: a quad on one side of the
// fold is one address and a stride, the quad across it four addresses.
__device__ __forceinline__ void quad_rows(const Rows& R, int k, int i0,
                                          const float* (&a)[4]) {
  if (k + 3 < R.h) {
    a[0] = R.base + k * R.SL + i0;
    a[1] = a[0] + R.SL;
    a[2] = a[1] + R.SL;
    a[3] = a[2] + R.SL;
  } else if (k >= R.h) {
    a[0] = R.base + (R.np - k) * R.SL - 4 - i0;
    a[1] = a[0] - R.SL;
    a[2] = a[1] - R.SL;
    a[3] = a[2] - R.SL;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = R.chunk(k + c, i0);
  }
}

// acc[m].c -= sum over the quads k = k0, k0 + 4, .., < k1 of
// own[m][k..k+3] . L[k..k+3][i0 + c], in order. Quad k's rows of L are
// a + q s (q < 4) with a advancing by 4 s per quad; they are read as rows
// and transposed in registers, the next quad's reads issued before this
// one's FMAs.
template <int NS, int MS>
__device__ __forceinline__ void backward_sums(float4 (&acc)[MS],
                                              float* const (&own)[MS],
                                              const float* a, int s, int k0,
                                              int k1) {
  if (k0 >= k1) return;
  float4 q0 = ld4(a), q1 = ld4(a + s), q2 = ld4(a + 2 * s), q3 = ld4(a + 3 * s);
  float4 o[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) o[m] = ld4(own[m] + k0);
  for (int k = k0; k < k1; k += 4) {
    const bool more = k + 4 < k1;
    const float* an = more ? a + 4 * s : a;
    const int kn = more ? k + 4 : k;
    const float4 n0 = ld4(an), n1 = ld4(an + s), n2 = ld4(an + 2 * s), n3 = ld4(an + 3 * s);
    float4 on[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) on[m] = ld4(own[m] + kn);
    const float4 c0 = make_float4(q0.x, q1.x, q2.x, q3.x);
    const float4 c1 = make_float4(q0.y, q1.y, q2.y, q3.y);
    const float4 c2 = make_float4(q0.z, q1.z, q2.z, q3.z);
    const float4 c3 = make_float4(q0.w, q1.w, q2.w, q3.w);
#pragma unroll
    for (int m = 0; m < NS; ++m) sub_quad(acc[m], o[m], c0, c1, c2, c3);
    a = an;
    q0 = n0;
    q1 = n1;
    q2 = n2;
    q3 = n3;
#pragma unroll
    for (int m = 0; m < NS; ++m) o[m] = on[m];
  }
}

// The same over all k in (i0 + 3, np): the quads before the fold, the one
// across it (when h % 4 != 0), the quads after it.
template <int NS, int MS>
__device__ __forceinline__ void backward_panel(float4 (&acc)[MS],
                                               float* const (&own)[MS],
                                               const Rows& R, int i0) {
  const int hq = R.h & ~3, hr = (R.h + 3) & ~3;
  int k = i0 + 4;
  if (k < hq) {
    backward_sums<NS>(acc, own, R.base + k * R.SL + i0, R.SL, k, hq);
    k = hq;
  }
  if (k < hr) {
    const float* a[4];
    quad_rows(R, k, i0, a);
    const float4 q0 = ld4(a[0]), q1 = ld4(a[1]), q2 = ld4(a[2]), q3 = ld4(a[3]);
    const float4 c0 = make_float4(q0.x, q1.x, q2.x, q3.x);
    const float4 c1 = make_float4(q0.y, q1.y, q2.y, q3.y);
    const float4 c2 = make_float4(q0.z, q1.z, q2.z, q3.z);
    const float4 c3 = make_float4(q0.w, q1.w, q2.w, q3.w);
#pragma unroll
    for (int m = 0; m < NS; ++m) sub_quad(acc[m], ld4(own[m] + k), c0, c1, c2, c3);
    k = hr;
  }
  if (k < R.np)
    backward_sums<NS>(acc, own, R.base + (R.np - k) * R.SL - 4 - i0, -R.SL, k, R.np);
}

// The 4 x 4 diagonal blocks of the two solves, for one right-hand side:
// its panel entries a (their sums over the other panels subtracted), the
// block's rows 1..3 of L (e1..e3, chunk i0; only their entries below the
// diagonal are read) and its reciprocal pivots rv. forward_block solves
// L[i0..i0+3] y = a from the first column, backward_block L^T x = a from
// the last.
__device__ __forceinline__ float4 forward_block(float4 a, float4 e1, float4 e2,
                                                float4 e3, float4 rv) {
  float4 y;
  y.x = a.x * rv.x;
  y.y = fmaf(-e1.x, y.x, a.y) * rv.y;
  y.z = fmaf(-e2.y, y.y, fmaf(-e2.x, y.x, a.z)) * rv.z;
  y.w = fmaf(-e3.z, y.z, fmaf(-e3.y, y.y, fmaf(-e3.x, y.x, a.w))) * rv.w;
  return y;
}

__device__ __forceinline__ float4 backward_block(float4 a, float4 e1, float4 e2,
                                                 float4 e3, float4 rv) {
  float4 x;
  x.w = a.w * rv.w;
  x.z = fmaf(-e3.z, x.w, a.z) * rv.z;
  x.y = fmaf(-e3.y, x.w, fmaf(-e2.y, x.z, a.y)) * rv.y;
  x.x = fmaf(-e3.x, x.w, fmaf(-e2.x, x.z, fmaf(-e1.x, x.y, a.x))) * rv.x;
  return x;
}

// Backward solve L^T x = y for R > 1: thread t owns right-hand-side rows
// np + t + T m and solves them alone, panel by panel from the last.
template <int W>
__device__ __forceinline__ void backward_rows(const Rows& R, const float* rinv,
                                              int nrow, int t) {
  constexpr int T = W * kWarp;
  constexpr int MS = 4 / W;
  for (int r0 = R.np; r0 < nrow; r0 += T * MS) {
    float* own[MS];
#pragma unroll
    for (int m = 0; m < MS; ++m) own[m] = R.row(min(r0 + t + T * m, nrow - 1));
    const int ns = (nrow - r0 + T - 1) / T;
    for (int i0 = R.np - 4; i0 >= 0; i0 -= 4) {
      float4 acc[MS];
#pragma unroll
      for (int m = 0; m < MS; ++m) acc[m] = ld4(own[m] + i0);
      if (ns == 1 || MS == 1) {
        backward_panel<1>(acc, own, R, i0);
      } else if (ns == 2 || MS == 2) {
        backward_panel<(MS > 1 ? 2 : 1)>(acc, own, R, i0);
      } else if (ns == 3) {
        backward_panel<(MS > 2 ? 3 : 1)>(acc, own, R, i0);
      } else {
        backward_panel<MS>(acc, own, R, i0);
      }
      const float* e[4];
      quad_rows(R, i0, i0, e);
      const float4 e1 = ld4(e[1]), e2 = ld4(e[2]), e3 = ld4(e[3]);
      const float4 rv = ld4(rinv + i0);
#pragma unroll
      for (int m = 0; m < MS; ++m)
        if (r0 + t + T * m < nrow)
          st4(own[m] + i0, backward_block(acc[m], e1, e2, e3, rv));
    }
  }
}

// Backward solve for R = 1, one warp: for each panel the lanes split the
// sum over k (lane l takes k = i0 + 4 + l, + 32, ...), a butterfly adds the
// partial sums, and every lane finishes the block; lane 0 stores it.
__device__ __forceinline__ void backward_vec(const Rows& R, const float* rinv,
                                             int lane) {
  float* x = R.ext;
  for (int i0 = R.np - 4; i0 >= 0; i0 -= 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = i0 + 4 + lane; k < R.np; k += kWarp) {
      const float4 q = ld4(R.chunk(k, i0));
      const float xk = x[k];
      s.x = fmaf(q.x, xk, s.x);
      s.y = fmaf(q.y, xk, s.y);
      s.z = fmaf(q.z, xk, s.z);
      s.w = fmaf(q.w, xk, s.w);
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
    }
    const float4 y = ld4(x + i0);
    const float* e[4];
    quad_rows(R, i0, i0, e);
    const float4 e1 = ld4(e[1]), e2 = ld4(e[2]), e3 = ld4(e[3]);
    const float4 v = backward_block(
        make_float4(y.x - s.x, y.y - s.y, y.z - s.z, y.w - s.w), e1, e2, e3,
        ld4(rinv + i0));
    __syncwarp();
    if (lane == 0) st4(x + i0, v);
    __syncwarp();
  }
}

// X out by tiles of 4 of its rows j by 8 columns c per warp (in shared
// memory, row np + c and column j, the 32 addresses fall in 32 banks).
template <int W>
__device__ __forceinline__ void store_x(const Rows& R, float* __restrict__ x,
                                        int n, int nr, int t) {
  const int lane = t % kWarp;
  const int cw = (t / kWarp) * 8 + (lane >> 2);
  for (int j = lane & 3; j < n; j += 4)
    for (int c = cw; c < nr; c += 8 * W) x[j * nr + c] = R.ext[c * R.Se + j];
}

// One warp: a floor of 16 blocks per SM caps the registers at 128 a
// thread, so at R = 1 sixteen envs share an SM, all 2048 in one wave. Two
// warps are not capped: at R = 55 the registers allow 6 blocks per SM and
// the shared memory 7, and a cap at 7 forces spills (PERF.md).
template <int W>
__global__ void __launch_bounds__(W * kWarp, W == 1 ? 16 : 1)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ L_out, float* __restrict__ X, int n,
                  int nr) {
  static_assert(W == 1 || W == 2, "one or two warps per env");
  extern __shared__ float4 smem4[];
  const Rows R(reinterpret_cast<float*>(smem4), n);
  const int nrow = R.np + nr;
  float* rinv = R.ext + nr * R.Se;
  float* dg = rinv + R.np;
  const int t = threadIdx.x;
  const size_t env = blockIdx.x;
  stage<W>(A + env * n * n, B + env * n * nr, R, n, nr, t);
  cp_async_wait();
  env_sync<W>();
  factor_forward<W>(R, rinv, dg, nrow, t);
  if (nr == 1) {
    if (t < kWarp) backward_vec(R, rinv, t);
  } else {
    backward_rows<W>(R, rinv, nrow, t);
  }
  env_sync<W>();
  // X out, then L row by row (K4b)
  store_x<W>(R, X + env * n * nr, n, nr, t);
  if (L_out != nullptr) {
    float* l = L_out + env * n * n;
    for (int r = 0; r < n; ++r) {
      const float* p = R.row(r);
      const int d = R.dir(r);
      for (int k = t; k < n; k += W * kWarp)
        l[r * n + k] = k <= r ? p[d * (k & ~3) + (k & 3)] : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// K4c

// 1 / d for a given pivot d: the hardware's reciprocal (at most 1 ulp
// off), without the IEEE division's branch to its slow path. A zero pivot
// gives an infinity, and X is then not finite, as the plain version's
// division gives.
__device__ __forceinline__ float rcp_pivot(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// The reciprocal pivots of the staged L, one per thread (1 on the padding
// rows). The caller's barrier follows.
template <int W>
__device__ __forceinline__ void pivots(const Rows& R, float* rinv, int t) {
  for (int j = t; j < R.np; j += W * kWarp) rinv[j] = rcp_pivot(R.at(j, j));
}

// Forward solve L y = b for R > 1, the mirror of backward_rows: thread t
// owns right-hand-side rows np + t + T m and solves them alone, panel by
// panel from the first, summing each panel's 4 entries over k < j0 as the
// factor does (panel_sums: its own row and the panel's 4 rows of L, read
// by broadcast), then against the panel's 4 x 4 block of L. No barrier.
template <int W>
__device__ __forceinline__ void forward_rows(const Rows& R, const float* rinv,
                                             int nrow, int t) {
  constexpr int T = W * kWarp;
  constexpr int MS = 4 / W;
  for (int r0 = R.np; r0 < nrow; r0 += T * MS) {
    RowRef own[MS];
#pragma unroll
    for (int m = 0; m < MS; ++m) own[m] = {R.row(min(r0 + t + T * m, nrow - 1)), 1};
    const int ns = (nrow - r0 + T - 1) / T;
    for (int j0 = 0; j0 < R.np; j0 += 4) {
      const RowRef q[4] = {{R.row(j0), R.dir(j0)}, {R.row(j0 + 1), R.dir(j0 + 1)},
                           {R.row(j0 + 2), R.dir(j0 + 2)}, {R.row(j0 + 3), R.dir(j0 + 3)}};
      float4 acc[MS];
#pragma unroll
      for (int m = 0; m < MS; ++m) acc[m] = ld4(own[m].p + j0);
      if (ns == 1 || MS == 1) {
        panel_sums<1>(acc, own, q, j0);
      } else if (ns == 2 || MS == 2) {
        panel_sums<(MS > 1 ? 2 : 1)>(acc, own, q, j0);
      } else if (ns == 3) {
        panel_sums<(MS > 2 ? 3 : 1)>(acc, own, q, j0);
      } else {
        panel_sums<MS>(acc, own, q, j0);
      }
      const float4 e1 = ld4(q[1].p + q[1].d * j0), e2 = ld4(q[2].p + q[2].d * j0),
                   e3 = ld4(q[3].p + q[3].d * j0), rv = ld4(rinv + j0);
#pragma unroll
      for (int m = 0; m < MS; ++m)
        if (r0 + t + T * m < nrow)
          st4(own[m].p + j0, forward_block(acc[m], e1, e2, e3, rv));
    }
  }
}

// Forward solve for R = 1, one warp: for each panel lane l sums the chunks
// k = 4 l, 4 l + 128, ... (k < j0) of the panel's 4 rows against y, a
// butterfly adds the partial sums, and every lane finishes the block; lane
// 0 stores it.
__device__ __forceinline__ void forward_vec(const Rows& R, const float* rinv,
                                            int lane) {
  float* y = R.ext;
  for (int j0 = 0; j0 < R.np; j0 += 4) {
    const RowRef q[4] = {{R.row(j0), R.dir(j0)}, {R.row(j0 + 1), R.dir(j0 + 1)},
                         {R.row(j0 + 2), R.dir(j0 + 2)}, {R.row(j0 + 3), R.dir(j0 + 3)}};
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 4 * lane; k < j0; k += 4 * kWarp) {
      const float4 v = ld4(y + k);
      const float4 q0 = ld4(q[0].p + q[0].d * k), q1 = ld4(q[1].p + q[1].d * k);
      const float4 q2 = ld4(q[2].p + q[2].d * k), q3 = ld4(q[3].p + q[3].d * k);
      s.x = fmaf(q0.w, v.w, fmaf(q0.z, v.z, fmaf(q0.y, v.y, fmaf(q0.x, v.x, s.x))));
      s.y = fmaf(q1.w, v.w, fmaf(q1.z, v.z, fmaf(q1.y, v.y, fmaf(q1.x, v.x, s.y))));
      s.z = fmaf(q2.w, v.w, fmaf(q2.z, v.z, fmaf(q2.y, v.y, fmaf(q2.x, v.x, s.z))));
      s.w = fmaf(q3.w, v.w, fmaf(q3.z, v.z, fmaf(q3.y, v.y, fmaf(q3.x, v.x, s.w))));
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
    }
    const float4 b = ld4(y + j0);
    const float4 v = forward_block(
        make_float4(b.x - s.x, b.y - s.y, b.z - s.z, b.w - s.w),
        ld4(q[1].p + q[1].d * j0), ld4(q[2].p + q[2].d * j0),
        ld4(q[3].p + q[3].d * j0), ld4(rinv + j0));
    __syncwarp();
    if (lane == 0) st4(y + j0, v);
    __syncwarp();
  }
}

// K4c in K4a's layout: L's triangle and B staged as stage() stages A and
// B, the reciprocal pivots, then the two solves (one warp, W = 1, at
// R = 1; W = 2 and rows per thread at R > 1).
template <int W>
__global__ void __launch_bounds__(W * kWarp, W == 1 ? 16 : 1)
chol_apply_kernel(const float* __restrict__ Lin, const float* __restrict__ B,
                  float* __restrict__ X, int n, int nr) {
  static_assert(W == 1 || W == 2, "one or two warps per env");
  extern __shared__ float4 smem4[];
  const Rows R(reinterpret_cast<float*>(smem4), n);
  const int nrow = R.np + nr;
  float* rinv = R.ext + nr * R.Se;
  const int t = threadIdx.x;
  const size_t env = blockIdx.x;
  stage<W>(Lin + env * n * n, B + env * n * nr, R, n, nr, t);
  cp_async_wait();
  env_sync<W>();
  pivots<W>(R, rinv, t);
  env_sync<W>();
  if (nr == 1) {
    if (t < kWarp) {
      forward_vec(R, rinv, t);
      backward_vec(R, rinv, t);
    }
  } else {
    forward_rows<W>(R, rinv, nrow, t);
    backward_rows<W>(R, rinv, nrow, t);
  }
  env_sync<W>();
  store_x<W>(R, X + env * n * nr, n, nr, t);
}

// ---------------------------------------------------------------------------
// Launches

void allow_large_smem(const void* fn) {
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kMaxSmem));
}

// One env per block of W warps: K4a (L null), K4b (L written) or, with
// apply, K4c (A is the given L), all three in the same shared memory.
template <int W>
int launch(const float* A, const float* B, float* L, float* X, int n_env,
           int n, int nr, bool apply, void* stream) {
  static const bool once = (allow_large_smem(
      reinterpret_cast<const void*>(chol_solve_kernel<W>)), allow_large_smem(
      reinterpret_cast<const void*>(chol_apply_kernel<W>)), true);
  (void)once;
  const size_t smem = sizeof(float) * solve_floats(n, nr);
  if (smem > kMaxSmem || n < 1 || nr < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (apply) {
    chol_apply_kernel<W><<<n_env, W * kWarp, smem, st>>>(A, B, X, n, nr);
  } else {
    chol_solve_kernel<W><<<n_env, W * kWarp, smem, st>>>(A, B, L, X, n, nr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Warps per env: one for a single right-hand side (its solves are one
// warp's), two for more.
int launch_env(const float* A, const float* B, float* L, float* X, int n_env,
               int n, int nr, bool apply, void* stream) {
  return nr == 1 ? launch<1>(A, B, L, X, n_env, n, nr, apply, stream)
                 : launch<2>(A, B, L, X, n_env, n, nr, apply, stream);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a size its kernel does not
// take. The Python wrapper checks the sizes first: n_env >= 1, and the
// shared memory within a block's 227 KB: 4 ((np + R) S + np + 16) bytes
// (np = n rounded up to 4, S = np or np + 4, whichever has S / 4 odd),
// the same for K4a, K4b and K4c.
extern "C" int chol_solve_only(const float* A, const float* B, float* X,
                               int n_env, int n, int nr, void* stream) {
  return launch_env(A, B, nullptr, X, n_env, n, nr, false, stream);
}

extern "C" int chol_factor_solve(const float* A, const float* B, float* L,
                                 float* X, int n_env, int n, int nr,
                                 void* stream) {
  return launch_env(A, B, L, X, n_env, n, nr, false, stream);
}

extern "C" int chol_apply(const float* L, const float* B, float* X,
                          int n_env, int n, int nr, void* stream) {
  return launch_env(L, B, nullptr, X, n_env, n, nr, true, stream);
}
