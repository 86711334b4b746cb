// The staging and culling helpers of K1's CTA skeleton (fused_xsect.cu),
// shared by K1, K7 (the unfused kernel, same file), K3 and K4 (the Voigt
// and SD-Voigt tangents, fused_xsect_jvp.cu), K5 and K6 (fused_ht.cu): the
// cp.async copies of the staging ring, the integer window ranges a staged
// (slot, row) pair is culled by, and the row accumulators' indexing; and
// the whole row skeleton that K4, K5 and K6 instantiate (row_skeleton).
// _build.py hashes this header into the name of every library whose source
// includes it, so an edit rebuilds them.
//
// It also holds the fast reciprocal (rcp_fast, rcp) and the switch between
// a source's two builds: fused_xsect.cu, fused_xsect_jvp.cu and fused_ht.cu
// build their kernels with IEEE division at the line shape's reciprocals;
// fused_xsect_fast.cu, fused_xsect_jvp_fast.cu and fused_ht_fast.cu define
// RADTXFR_FAST 1 and include them, which instantiates the kernels with
// FAST true (the TPU kernels' fast_rcp=True) in libraries of their own,
// their C entries named with _fast at the end (RADTXFR_ENTRY). One nvcc a
// source, all started together, so the FAST variants cost the build no
// wall time of its own.

#pragma once

#include <cuda_runtime.h>

#ifndef RADTXFR_FAST
#define RADTXFR_FAST 0
#endif
#if RADTXFR_FAST
#define RADTXFR_ENTRY(name) name##_fast
#else
#define RADTXFR_ENTRY(name) name
#endif

namespace {

// the FAST value this build instantiates its kernels with
constexpr bool BUILD_FAST = RADTXFR_FAST != 0;

constexpr float REGION_BOUND = 15.0f;   // hum1_wei's |x| + y < 15
constexpr int RING = 3;                 // chunks of slot data in flight

// The TPU kernels' fast reciprocal (pallas_xsect.py::_rcp with fast=True:
// pl.reciprocal(x, approx=True), then one Newton step r (2 - x r)): the
// approximate reciprocal rcp.approx.f32 (not .ftz, so that subnormals stay
// as in the kernels' other arithmetic) and the Newton step in JAX's order,
// each operation rounded on its own (__fmul_rn, __fsub_rn: no contraction
// into an FMA). Within an ulp or two of 1/x; x = 0 or +-inf gives NaN
// (0 * inf), as on the TPU. Hand-written PTX, not a library call and not
// --use_fast_math.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float rcp_fast(float x) {
  const float r = rcp_approx(x);
  return __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(x, r)));
}

// 1/x at a site where JAX calls _rcp(., fast): the fast reciprocal in a
// FAST instantiation, else IEEE division
template <bool FAST>
__device__ __forceinline__ float rcp(float x) {
  if constexpr (FAST)
    return rcp_fast(x);
  else
    return 1.0f / x;
}

// Staged per-(line, layer) constants (each mode's layout:
// fused_xsect.cu::line_const, fused_xsect_jvp.cu's K3 and K4): a.z is the
// window half-width wingu in grid steps in every mode; in the Voigt modes
// a.x, a.y are the grid shift ds and the x scale xs and b.x is y
struct LineConst {
  float4 a;
  float4 b;
};

// a 4-byte asynchronous copy from device to shared memory (sm_80+)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The grid indices d - k_line (a superset) at which a slot can pass the
// window test u > -wingu && u <= wingu, u = float(d) - frac0: the float
// rounding of u and of frac0 -+ wingu stays under a grid step while
// |d|, wingu < 2^22, and wider (or NaN) windows take every index.
__device__ __forceinline__ int2 window_range(float f0, float wingu) {
  if (!(wingu <= 4194304.0f)) return make_int2(-(1 << 30), 1 << 30);
  return make_int2(static_cast<int>(floorf(f0 - wingu)) - 2,
                   static_cast<int>(ceilf(f0 + wingu)) + 2);
}

// The indices d (a superset) at which a Voigt pair lies inside hum1_wei's
// |x| + y < 15, x = (d - frac0 - ds) xs: |d - (frac0 + ds)| < (15 - y) /
// xs, widened by 1e-4 of the radius and a grid step, intersected with the
// window range win; empty (lo > hi) where y >= 15
__device__ __forceinline__ int2 core_range(float f0, const LineConst& c,
                                           int2 win) {
  const float r = (REGION_BOUND - c.b.x) / c.a.y;
  if (!(r > 0.0f)) return make_int2(1, 0);
  const int2 cw = window_range(f0 + c.a.x, r * 1.0001f + 1.0f);
  return make_int2(max(win.x, cw.x), min(win.y, cw.y));
}

// a constant index into a register array from a loop variable (a row loop
// kept rolled: its body is a whole line-shape evaluation)
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? a[j] : v;
  return v;
}
template <int N>
__device__ __forceinline__ void put(float (&a)[N], int i, float v) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = i == j ? v : a[j];
}

// ---- the row skeleton of K4, K5 and K6 ---------------------------------------
//
// One CTA per (ROW_SPAN-point slice of a tile, ROW_LC output rows r = d *
// n_lay_call + l: a direction's layer, or K5's layer; a tile's points at
// the global grid indices t0 + k + tile_off[tile], K1's convention), four
// warps, each
// owning one 32-point span of the slice and staging one row. A row whose
// direction has no non-zero tangent on its layer (the (n_dir, n_lay) table
// `live`) stages nothing; a CTA without a live row writes its zeros and
// stops. The tile's slots go through the cp.async ring (slot data two
// chunks ahead; the row's parameters, and its direction's tangents, one
// chunk ahead). Each staged (slot, row) pair gets its integer window
// (window_range on the capped wing, as the per-point test computes it) and
// is kept, per row in slot order (ballot and prefix count), only if the
// window meets the slice (and, with tangents, one of its direction's is
// non-zero); the policy then computes its point-independent values once and
// its Weideman range. Each warp tests a kept pair's window against its
// span with a warp-uniform compare before any lane evaluates, and tells the
// policy whether the span lies wholly outside the Weideman range (far: no
// point of it can take the Weideman branch). Every output is written once
// by one thread: no atomics.
//
// The policy P gives the line shape:
//   N_PRM, N_TAN  parameters of a (layer, line) and tangents of a
//                 (direction, layer, line) staged (N_TAN 0: none, and every
//                 row is live); I_WING the wing's index among the parameters
//   MAX_WEI       the Weideman terms it takes at most
//   Ptrs          {p[N_PRM], t[...]}: the (nLay, L) and (n_dir, nLay, L) rows
//   Kept          each row's kept pairs' values ([ROW_LC][ROW_CH] arrays)
//   stage(kept, raw, i, j, pos, f0, wingu, win, dx)  stores row i's staged
//                 slot j as kept pair pos, returns its Weideman range (grid
//                 offsets from k_line, within win)
//   eval(sum, kept, i, k, u, pt_live, far, wei, n_wei, dx)  sum with kept
//                 pair k's term at offset u added where the point is live
//                 and in the window

constexpr int ROW_THREADS = 128;             // threads per CTA, one point each
constexpr int ROW_NWARP = ROW_THREADS / 32;  // one 32-point span each
constexpr int ROW_SPAN = ROW_THREADS;        // points per CTA
constexpr int ROW_LC = ROW_NWARP;            // rows per CTA, one staged a warp
constexpr int ROW_CH = 32;                   // slots staged a chunk, a lane each
static_assert(ROW_CH == 32 && ROW_LC == ROW_NWARP,
              "a warp stages one row, a lane a slot");

// A row kernel's arguments (sub_per_tile set by row_launch)
template <class Ptrs>
struct RowArgs {
  const int* starts;
  const int* counts;
  const int* k_line;
  const float* frac0;
  const int* line;
  const float* wcap;
  const int* tile_off;
  const int* lay_idx;
  int n_lay_call;
  const int* live;
  Ptrs ptr;
  int n_dir, n_lay, n_lines;
  const float* wei;
  int n_wei, tile, block, sub_per_tile, n_out;
  float dx;
  float* out;
};

// A row CTA's shared memory: K1's ring of slot data, the raw parameters
// (and tangents) of the next chunk's (slot, row) pairs, and each row's kept
// pairs in slot order: the policy's values, (window lo, hi, k_line, frac0
// bits) and Weideman range (lo, hi; absolute)
template <class P>
struct RowSmem {
  int k[RING][ROW_CH];
  float f[RING][ROW_CH];
  int line[RING][ROW_CH];
  float cap[RING][ROW_CH];
  float raw[P::N_PRM + P::N_TAN][ROW_LC][ROW_CH];
  typename P::Kept kept;
  int4 meta[ROW_LC][ROW_CH];
  int2 near[ROW_LC][ROW_CH];
  int n[ROW_LC];
};

// (A by reference: taken by value, ptxas gave K5 66 registers in place of
// 61, 7 CTAs an SM in place of 8)
template <class P>
__device__ __forceinline__ void row_skeleton(
    const RowArgs<typename P::Ptrs>& A, RowSmem<P>& sm, float* s_wei) {
  constexpr bool TAN = P::N_TAN > 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile_i = blockIdx.x / A.sub_per_tile;
  const int sub = blockIdx.x - tile_i * A.sub_per_tile;
  const int r0 = blockIdx.y * ROW_LC;
  const int nr = min(ROW_LC, A.n_dir * A.n_lay_call - r0);
  const int t0 = tile_i * A.tile;
  const int kloc0 = sub * ROW_SPAN;
  // a slice past the grid's end has no output: the whole CTA leaves
  if (t0 + kloc0 >= A.n_out) return;
  // the tile's grid offset (nullptr: zero): staged k_line values are
  // shifted by -goff, so the windows, the culling and u below work in the
  // local indices that address the output, and u = (k_local + goff) -
  // k_line - frac0 is the int32 difference of the global index
  const int goff = A.tile_off != nullptr ? A.tile_off[tile_i] : 0;
  const int last = min(kloc0 + ROW_SPAN, A.tile) - 1;
  const int r_lo = t0 + kloc0;                 // the slice's grid indices
  const int r_hi = min(t0 + last, A.n_out - 1);
  const int a = t0 + kloc0 + warp * 32;        // this warp's first point
  const bool warp_live = kloc0 + warp * 32 <= last && a < A.n_out;
  const int kg = a + lane;
  const bool pt_live = kloc0 + warp * 32 + lane <= last && kg < A.n_out;

  float acc[ROW_LC];
#pragma unroll
  for (int i = 0; i < ROW_LC; ++i) acc[i] = 0.0f;

  // the row this warp stages: its parameter and tangent offsets, liveness
  bool row_live = false;
  size_t p_off = 0, t_off = 0;
  if (warp < nr) {
    const int r = r0 + warp;
    const int d = r / A.n_lay_call;
    const int pl = A.lay_idx[r - d * A.n_lay_call];
    row_live = !TAN || A.live[d * A.n_lay + pl] != 0;
    p_off = static_cast<size_t>(pl) * A.n_lines;
    t_off = static_cast<size_t>(d) * A.n_lay * A.n_lines + p_off;
  }

  if (__syncthreads_or(row_live)) {
    for (int i = tid; i <= A.n_wei; i += ROW_THREADS) s_wei[i] = A.wei[i];
    const int slot0 = A.starts[tile_i] * A.block;
    const int n_slots = A.counts[tile_i] * A.block;
    const int n_chunks = (n_slots + ROW_CH - 1) / ROW_CH;

    // slot data of chunk ch into its ring entry
    auto issue_slots = [&](int ch) {
      const int c0 = ch * ROW_CH;
      const int nc = min(ROW_CH, n_slots - c0);
      const int r = ch % RING;
      for (int j = tid; j < nc; j += ROW_THREADS) {
        const int s = slot0 + c0 + j;
        cp_async4(&sm.k[r][j], A.k_line + s);
        cp_async4(&sm.f[r][j], A.frac0 + s);
        cp_async4(&sm.line[r][j], A.line + s);
        cp_async4(&sm.cap[r][j], A.wcap + s);
      }
    };
    // raw parameters (and tangents) of chunk ch's pairs of this warp's row
    auto issue_params = [&](int ch) {
      const int j = lane;
      const int r = ch % RING;
      if (!row_live || j >= min(ROW_CH, n_slots - ch * ROW_CH)) return;
      const int g = sm.line[r][j];
      if (g < 0) return;
#pragma unroll
      for (int q = 0; q < P::N_PRM; ++q)
        cp_async4(&sm.raw[q][warp][j], A.ptr.p[q] + p_off + g);
      if constexpr (TAN) {
#pragma unroll
        for (int q = 0; q < P::N_TAN; ++q)
          cp_async4(&sm.raw[P::N_PRM + q][warp][j], A.ptr.t[q] + t_off + g);
      }
    };

    if (n_chunks > 0) issue_slots(0);
    cp_async_commit();
    if (n_chunks > 1) issue_slots(1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (n_chunks > 0) issue_params(0);
    cp_async_commit();

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int nc = min(ROW_CH, n_slots - ch * ROW_CH);
      const int r = ch % RING;
      cp_async_wait<0>();
      __syncthreads();   // chunk ch's parameters and ch + 1's slots are in;
                         // the previous chunk is consumed
      // this warp's row: windows, live tangents and the kept pairs
      {
        const int i = warp;
        const int j = lane;
        bool keep = false;
        int2 win = make_int2(1, 0);
        int kl = 0;
        float f0 = 0.0f, wu = 0.0f;
        if (row_live && j < nc && sm.line[r][j] >= 0) {
          kl = sm.k[r][j] - goff;
          f0 = sm.f[r][j];
          wu = fminf(sm.raw[P::I_WING][i][j], sm.cap[r][j]) / A.dx;
          win = window_range(f0, wu);
          bool tz = !TAN;
          if constexpr (TAN) {
#pragma unroll
            for (int e = 0; e < P::N_TAN; ++e)
              tz |= sm.raw[P::N_PRM + e][i][j] != 0.0f;
          }
          keep = tz && win.x <= win.y && kl + win.y >= r_lo &&
                 kl + win.x <= r_hi;
        }
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          const int pos = __popc(bal & ((1u << lane) - 1u));
          const int2 nrg = P::stage(sm.kept, sm.raw, i, j, pos, f0, wu, win,
                                    A.dx);
          sm.meta[i][pos] = make_int4(kl + win.x, kl + win.y, kl,
                                      __float_as_int(f0));
          sm.near[i][pos] = make_int2(kl + nrg.x, kl + nrg.y);
        }
        if (lane == 0) sm.n[i] = __popc(bal);
      }
      __syncthreads();
      if (ch + 1 < n_chunks) issue_params(ch + 1);
      if (ch + 2 < n_chunks) issue_slots(ch + 2);
      cp_async_commit();

      if (warp_live) {
#pragma unroll 1
        for (int i = 0; i < nr; ++i) {
          const int n = sm.n[i];
          if (n == 0) continue;
          float sum = pick(acc, i);
          for (int k = 0; k < n; ++k) {
            const int4 mt = sm.meta[i][k];
            // warp-uniform: does the window meet this warp's span?
            if (mt.y < a || mt.x > a + 31) continue;
            const int2 nrg = sm.near[i][k];
            // warp-uniform: the span lies outside the Weideman range
            const bool far = nrg.y < a || nrg.x > a + 31;
            const float u = static_cast<float>(kg - mt.z) -
                            __int_as_float(mt.w);
            sum = P::eval(sum, sm.kept, i, k, u, pt_live, far, s_wei,
                          A.n_wei, A.dx);
          }
          put(acc, i, sum);
        }
      }
    }
    cp_async_wait<0>();
  }

  // every row of the CTA, live or not (a dead row's sums are zeros)
  if (!pt_live) return;
#pragma unroll
  for (int i = 0; i < ROW_LC; ++i)
    if (i < nr) A.out[static_cast<size_t>(r0 + i) * A.n_out + kg] = acc[i];
}

// Launch a row kernel (one instantiating row_skeleton<P>) over n_tiles
// tiles; cudaErrorInvalidValue for arguments it does not take
template <class P>
int row_launch(void (*kernel)(RowArgs<typename P::Ptrs>),
               const void* starts, const void* counts, const void* k_line,
               const void* frac0, const void* line, const void* wcap,
               const void* tile_off, const void* lay_idx, int n_lay_call,
               const void* live,
               const typename P::Ptrs& ptr, int n_dir, int n_lay, int n_lines,
               const void* wei, int n_wei, int tile, int block, int n_tiles,
               int n_out, double dx, void* out, void* stream) {
  const long long row_groups =
      (static_cast<long long>(n_dir) * n_lay_call + ROW_LC - 1) / ROW_LC;
  if (n_wei < 1 || n_wei > P::MAX_WEI || tile < 1 || block < 1 ||
      n_dir < 1 || row_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_per_tile = (tile + ROW_SPAN - 1) / ROW_SPAN;
  const dim3 grid(static_cast<unsigned>(n_tiles) * sub_per_tile,
                  static_cast<unsigned>(row_groups));
  if (grid.x == 0 || grid.y == 0) return 0;
  const RowArgs<typename P::Ptrs> a = {
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const int*>(k_line), static_cast<const float*>(frac0),
      static_cast<const int*>(line), static_cast<const float*>(wcap),
      static_cast<const int*>(tile_off), static_cast<const int*>(lay_idx),
      n_lay_call,
      static_cast<const int*>(live), ptr, n_dir, n_lay, n_lines,
      static_cast<const float*>(wei), n_wei, tile, block, sub_per_tile, n_out,
      static_cast<float>(dx), static_cast<float*>(out)};
  kernel<<<grid, ROW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
