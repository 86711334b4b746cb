// K3 and K4: the tangents of the layered Voigt (mode full) and SD-Voigt
// (mode sdvoigt) line-shape accumulations for Hopper (sm_90a), for a batch
// of tangent directions. Both run K1's CTA skeleton over (direction, layer)
// output rows, cull and compact each row's (slot, row) pairs by integer
// window and live direction, and evaluate spans outside every Weideman
// region branch-free; FP32 issue bounds both. K3's note follows; K4's
// precedes its kernel below.
//
// Replaces radtxfr_tpu/kernels/pallas_xsect.py::_make_fused_jvp_kernel
// (launcher _xsect_fused_jvp_call, the JVP rule of xsect_fused_voigt_diff).
// For each nu-tile i, layer l and direction d it computes
//     tan[d, l, i*tile + k] = sum over the tile's packed line slots of
//         mask(u) * (cs_d K - cgd_d (K + x Kx + y Ky) + cg0_d Ky - cds_d Kx)
// with u as in K1, at the global grid index i*tile + k + tile_off[i]
// (fused_xsect.cu; K4 likewise, through row_skeleton),
// with x = (u - ds) dx cte, y = gamma_0 cte, cte = sqrt(ln2)/gamma_d,
// A = cte/sqrt(pi), sA = strength A and the per-(line, layer, direction)
// coefficients
//     cs = strength_t A,  cgd = gamma_d_t (sA/gamma_d),
//     cg0 = gamma_0_t (sA cte),  cds = (shift0_t/dx) (sA dx cte),
// JAX's grouping of the four terms (pallas_xsect.py:1271-1274). (K, Kx, Ky)
// are the region-consistent derivatives of each approximation: Weideman
// inside |x| + y < 15 (P' by a second Horner accumulator), the asymptotic
// form's own derivative outside (pallas_xsect.py::_voigt_K_grads), not the
// exact-Faddeeva identity, which cancels ~4 digits in the far wing. The
// window mask -wingu < u <= wingu is held fixed: wing tangents are dropped.
//
// Shape: K1's skeleton (fused_xsect.cu, k1_skeleton.cuh), over rows. The
// JAX vmap over tangent directions becomes the rows (d, l) of the output,
// r = d * n_lay_call + l: one CTA per (128-point slice of a tile, K3_LC
// rows), two warps of 64 points. The rows whose direction has no non-zero
// tangent on their layer (the wrapper's (nd, nLay) table `live`) stage
// nothing; a CTA without a live row writes its zeros and stops. For the
// one-hot directions of a Jacobian batch (a direction live on one layer)
// only the rows (d, layer of d) work, and each evaluation updates the one
// direction that is live (a dense direction axis would update all 8
// directions of every evaluation, 7 of them with exact zeros). The
// tile's slots go through the cp.async ring (slot data two chunks ahead;
// the row's 5 primal and 4 tangent parameters one chunk ahead); each staged
// (slot, row) pair gets its constants, its four coefficients and its integer
// window (window_range, wing capped by wcap), and is kept, per row in slot
// order (ballot and prefix count), only if a coefficient is non-zero and the
// window meets the slice. Each warp tests a kept pair against its 64
// points and its two 32-point spans with a warp-uniform compare; a span
// wholly outside core_range runs the asymptotic gradients branch-free, and
// only spans that meet the core branch per lane into Weideman. A culled
// pair or span holds only points whose window test fails or whose terms are
// exact zeros (all four coefficients zero), so each (direction, layer,
// point) adds the same terms in slot order as a walk over every slot with
// every direction would, up to nvcc's contraction of a lone direction's
// term (PERF.md). Every output is written once by one thread: no atomics;
// the same inputs give bit-identical outputs.
//
// Bound. Hand counts per evaluation (lane-ops as in
// pallas_xsect.py::_ops_per_eval, a*b+c = 2): prelude and window 11, region
// test 3, asymptotic (K, Kx, Ky) 36 or Weideman (K, Kx, Ky) 30 + 16 n_wei
// (two complex Horner accumulators), K + x Kx + y Ky 4: 54 outside the core,
// 48 + 16 n_wei inside, once per live (slot, layer) in-window evaluation,
// and 8 per live direction (four products, three adds, the accumulate) of
// each. The outputs' bytes bound a one-hot Jacobian batch (8 x nLay rows,
// most of them zeros); FP32 issue bounds denser ones, the inner loop
// reading shared memory only.
// chip_smoke.py recounts the live in-window and in-core evaluations and the
// live (evaluation, direction) products on the host, and the issue slots
// from this file's SASS (tools/sass.py::k3_eval_instructions).
//
// Numerics: float32, IEEE division (no --use_fast_math) but at the two
// reciprocals where JAX's kernel calls _rcp(., fast) (asym_k_grads' 1/|0.5
// - z^2|^2, weideman_k_grads' 1/|e|^2): rcp<FAST>, IEEE in this file's
// build, the fast reciprocal in fused_xsect_jvp_fast.cu's; nvcc contracts
// a*b+c into FMA, a float-rounding-level difference from XLA.

#include <cuda_runtime.h>

#include "k1_skeleton.cuh"

namespace {

constexpr int THREADS = 64;            // K3: threads per CTA
constexpr int CH = 32;                 // K3: line slots staged per step
constexpr int MAX_WEI = 32;            // Weideman terms at most
constexpr int K3_PPT = 2;              // K3: grid points per thread
constexpr int K3_SPAN = THREADS * K3_PPT;   // K3: points per CTA
constexpr int K3_LC = 4;               // K3: (direction, layer) rows per CTA

constexpr float SQRT_LN2 = static_cast<float>(0.8325546111576977);
constexpr float INV_SQRT_PI = static_cast<float>(0.5641895835477563);

// (struct LineConst: k1_skeleton.cuh) K3: a = (ds, xs, wingu, 0),
// b = (y, 0.5 + y*y, -2*y, 0)

struct KGrads {
  float K, Kx, Ky;
};

// (K, dK/dx, dK/dy) of the unguarded asymptotic form
// (pallas_xsect.py::_asym_K_grads).
template <bool FAST>
__device__ __forceinline__ KGrads asym_k_grads(float x, float y,
                                               const float4& b) {
  const float dr = b.y - x * x;        // 0.5 + y^2 - x^2
  const float di = b.z * x;            // -2 x y
  const float inv = rcp<FAST>(dr * dr + di * di);
  KGrads g;
  g.K = INV_SQRT_PI * (y * dr - x * di) * inv;
  const float nr = 0.5f + x * x - y * y;
  const float ni = -di;
  const float d2r = dr * dr - di * di;
  const float d2i = 2.0f * dr * di;
  const float inv2 = inv * inv;
  const float mr = nr * d2r + ni * d2i;
  const float mi = ni * d2r - nr * d2i;
  g.Kx = INV_SQRT_PI * mi * inv2;
  g.Ky = INV_SQRT_PI * mr * inv2;
  return g;
}

// (K, dK/dx, dK/dy) of the Weideman series (|x| + y < 15;
// pallas_xsect.py::_weideman_K_grads); wei = [L, a_0 .. a_{n-1}].
template <bool FAST>
__device__ __forceinline__ KGrads weideman_k_grads(float x, float y,
                                                   const float* wei,
                                                   int n_wei) {
  const float L = wei[0];
  const float er = L + y, ei = -x;
  const float inv_e = rcp<FAST>(er * er + ei * ei);
  const float ier = er * inv_e, iei = -ei * inv_e;
  const float nr = L - y, ni = x;
  const float zr = (nr * er + ni * ei) * inv_e;
  const float zi = (ni * er - nr * ei) * inv_e;
  float pr = wei[1], pi = 0.0f, qr = 0.0f, qi = 0.0f;
  for (int k = 2; k <= n_wei; ++k) {
    const float tqr = qr * zr - qi * zi + pr;
    qi = qr * zi + qi * zr + pi;
    qr = tqr;
    const float tpr = pr * zr - pi * zi + wei[k];
    pi = pr * zi + pi * zr;
    pr = tpr;
  }
  const float i2r = ier * ier - iei * iei, i2i = 2.0f * ier * iei;
  const float i3r = i2r * ier - i2i * iei, i3i = i2r * iei + i2i * ier;
  const float i4r = i2r * i2r - i2i * i2i, i4i = 2.0f * i2r * i2i;
  const float c4 = 4.0f * L;
  const float Qr = c4 * (qr * i4r - qi * i4i) + 4.0f * (pr * i3r - pi * i3i) +
                   INV_SQRT_PI * i2r;
  const float Qi = c4 * (qr * i4i + qi * i4r) + 4.0f * (pr * i3i + pi * i3r) +
                   INV_SQRT_PI * i2i;
  KGrads g;
  g.K = 2.0f * (pr * i2r - pi * i2i) + INV_SQRT_PI * ier;
  g.Kx = -Qi;
  g.Ky = -Qr;
  return g;
}

// One direction's term of a K3 evaluation at grid offset u: (K, Kx, Ky) by
// hum1_wei's region rule (CORE false: the caller knows the point lies
// outside |x| + y < 15, the asymptotic form's), combined with the
// direction's coefficients t = (cs, cgd, cg0, cds)
template <bool CORE, bool FAST>
__device__ __forceinline__ float tangent_term(float u, const LineConst& c,
                                              const float4& t,
                                              const float* wei, int n_wei) {
  const float x = (u - c.a.x) * c.a.y;
  const float y = c.b.x;
  const KGrads g = CORE && fabsf(x) + y < REGION_BOUND
                       ? weideman_k_grads<FAST>(x, y, wei, n_wei)
                       : asym_k_grads<FAST>(x, y, c.b);
  const float G = g.K + x * g.Kx + y * g.Ky;
  return t.x * g.K - t.y * G + t.z * g.Ky - t.w * g.Kx;
}

constexpr int K3_NRAW = 9;   // shift0, strength, gamma_d, gamma_0, wing,
                             // shift0_t, strength_t, gamma_d_t, gamma_0_t

// A K3 CTA's shared memory: K1's ring of slot data and raw parameters, and
// each row's kept pairs in slot order: their constants, coefficients,
// (window lo, hi, k_line, frac0 bits) and core range (lo, hi; absolute)
template <int NCH>
struct K3Smem {
  int k[RING][NCH];
  float f[RING][NCH];
  int line[RING][NCH];
  float cap[RING][NCH];
  float raw[K3_NRAW][K3_LC][NCH];
  LineConst c[K3_LC][NCH];
  float4 t[K3_LC][NCH];
  int4 meta[K3_LC][NCH];
  int2 core[K3_LC][NCH];
  int n[K3_LC];
};

// Occupancy: 15.4 KB of shared memory and at most 72 registers a thread
// (14 CTAs an SM; 44 bytes of spills), chosen by timing 8-16 CTAs and
// 128- against 256-point slices: a T direction over all layers is
// evaluation-bound and slows with fewer CTAs or larger slices (PERF.md)
constexpr int K3_MIN_CTAS = 14;

template <bool FAST>
__global__ void __launch_bounds__(THREADS, K3_MIN_CTAS)
fused_xsect_jvp_kernel(const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const int* __restrict__ k_line,
                       const float* __restrict__ frac0,
                       const int* __restrict__ line,
                       const float* __restrict__ wcap,
                       const int* __restrict__ tile_off,
                       const int* __restrict__ lay_idx, int n_lay_call,
                       const int* __restrict__ live,
                       const float* __restrict__ shift0,
                       const float* __restrict__ strength,
                       const float* __restrict__ gamma_d,
                       const float* __restrict__ gamma_0,
                       const float* __restrict__ wing,
                       const float* __restrict__ shift0_t,
                       const float* __restrict__ strength_t,
                       const float* __restrict__ gamma_d_t,
                       const float* __restrict__ gamma_0_t, int n_dir,
                       int n_lay, int n_lines,
                       const float* __restrict__ wei_g, int n_wei, int tile,
                       int block, int sub_per_tile, int n_out, float dx,
                       float* __restrict__ out) {
  constexpr int NL = K3_LC;
  constexpr int NCH = CH;
  constexpr int NWARP = THREADS / 32;
  constexpr int WPTS = 32 * K3_PPT;      // points of a warp
  constexpr int LPW = NL / NWARP;        // rows each warp stages
  static_assert(K3_SPAN == NWARP * WPTS && NL % NWARP == 0 &&
                    NCH % 32 == 0,
                "two warps of 32 K3_PPT points, K3_LC rows split between "
                "them");
  __shared__ K3Smem<NCH> sm;
  __shared__ float s_wei[MAX_WEI + 1];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile_i = blockIdx.x / sub_per_tile;
  const int sub = blockIdx.x - tile_i * sub_per_tile;
  const int n_rows = n_dir * n_lay_call;
  const int r0 = blockIdx.y * NL;
  const int nr = min(NL, n_rows - r0);
  const int t0 = tile_i * tile;
  if (t0 + sub * K3_SPAN >= n_out) return;
  // the tile's grid offset (K1's convention: staged k_line shifted by it)
  const int goff = tile_off != nullptr ? tile_off[tile_i] : 0;

  const int kloc0 = sub * K3_SPAN;
  const int last = min(kloc0 + K3_SPAN, tile) - 1;
  const int r_lo = t0 + kloc0;                 // the slice's grid indices
  const int r_hi = min(t0 + last, n_out - 1);
  const int wk0 = t0 + kloc0 + warp * WPTS;   // this warp's first point
  const bool warp_live = kloc0 + warp * WPTS <= last && wk0 < n_out;

  int kg[K3_PPT];
  bool pt_live[K3_PPT];
#pragma unroll
  for (int p = 0; p < K3_PPT; ++p) {
    const int kloc = kloc0 + warp * WPTS + p * 32 + lane;
    kg[p] = t0 + kloc;
    pt_live[p] = kloc < tile && kg[p] < n_out;
  }

  float acc[NL][K3_PPT];
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int p = 0; p < K3_PPT; ++p) acc[i][p] = 0.0f;

  // row r's parameter layer and its liveness; every thread reads all rows
  auto row_layer = [&](int r, int& d) {
    d = r / n_lay_call;
    return lay_idx[r - d * n_lay_call];
  };
  bool any_live = false;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    if (i < nr) {
      int d;
      const int pl = row_layer(r0 + i, d);
      any_live |= live[d * n_lay + pl] != 0;
    }
  }

  if (any_live) {
    for (int i = tid; i <= n_wei; i += THREADS) s_wei[i] = wei_g[i];
    // the parameter and tangent rows of the rows this thread stages
    size_t p_off[LPW], t_off[LPW];
    bool row_live[LPW];
#pragma unroll
    for (int t = 0; t < LPW; ++t) {
      const int i = warp + NWARP * t;
      p_off[t] = t_off[t] = 0;
      row_live[t] = false;
      if (i < nr) {
        int d;
        const int pl = row_layer(r0 + i, d);
        row_live[t] = live[d * n_lay + pl] != 0;
        p_off[t] = static_cast<size_t>(pl) * n_lines;
        t_off[t] = static_cast<size_t>(d) * n_lay * n_lines + p_off[t];
      }
    }

    const int slot0 = starts[tile_i] * block;
    const int n_slots = counts[tile_i] * block;
    const int n_chunks = (n_slots + NCH - 1) / NCH;

    // slot data of chunk ch into its ring entry
    auto issue_slots = [&](int ch) {
      const int c0 = ch * NCH;
      const int nc = min(NCH, n_slots - c0);
      const int r = ch % RING;
      for (int j = tid; j < nc; j += THREADS) {
        const int s = slot0 + c0 + j;
        cp_async4(&sm.k[r][j], k_line + s);
        cp_async4(&sm.f[r][j], frac0 + s);
        cp_async4(&sm.line[r][j], line + s);
        cp_async4(&sm.cap[r][j], wcap + s);
      }
    };
    // raw parameters of chunk ch's (row, slot) pairs, rows by its lines
    auto issue_params = [&](int ch) {
      const int nc = min(NCH, n_slots - ch * NCH);
      const int r = ch % RING;
#pragma unroll
      for (int t = 0; t < LPW; ++t) {
        if (!row_live[t]) continue;
        const int i = warp + NWARP * t;
        for (int j = lane; j < nc; j += 32) {
          const int g = sm.line[r][j];
          if (g < 0) continue;
          const size_t off = p_off[t] + g, toff = t_off[t] + g;
          cp_async4(&sm.raw[0][i][j], shift0 + off);
          cp_async4(&sm.raw[1][i][j], strength + off);
          cp_async4(&sm.raw[2][i][j], gamma_d + off);
          cp_async4(&sm.raw[3][i][j], gamma_0 + off);
          cp_async4(&sm.raw[4][i][j], wing + off);
          cp_async4(&sm.raw[5][i][j], shift0_t + toff);
          cp_async4(&sm.raw[6][i][j], strength_t + toff);
          cp_async4(&sm.raw[7][i][j], gamma_d_t + toff);
          cp_async4(&sm.raw[8][i][j], gamma_0_t + toff);
        }
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
      const int nc = min(NCH, n_slots - ch * NCH);
      const int r = ch % RING;
      cp_async_wait<0>();
      __syncthreads();   // chunk ch's parameters and ch + 1's slots are in;
                         // the previous chunk is consumed
      // constants, coefficients, windows and each row's kept pairs
#pragma unroll
      for (int t = 0; t < LPW; ++t) {
        const int i = warp + NWARP * t;
        int n_kept = 0;
#pragma unroll
        for (int q = 0; q < NCH / 32; ++q) {
          const int j = q * 32 + lane;
          bool keep = false;
          LineConst c;
          float4 tc;
          int2 win, cr;
          int kl = 0;
          float f0 = 0.0f;
          if (row_live[t] && j < nc && sm.line[r][j] >= 0) {
            kl = sm.k[r][j] - goff;
            f0 = sm.f[r][j];
            // the per-(line, layer) constants and coefficients
            const float gd = sm.raw[2][i][j];
            const float cte = SQRT_LN2 / gd;
            const float y = sm.raw[3][i][j] * cte;
            const float xs = dx * cte;
            const float A = INV_SQRT_PI * cte;
            const float sA = sm.raw[1][i][j] * A;
            const float k_gd = sA / gd, k_g0 = sA * cte, k_ds = sA * xs;
            c.a = make_float4(sm.raw[0][i][j] / dx, xs,
                              fminf(sm.raw[4][i][j], sm.cap[r][j]) / dx,
                              0.0f);
            c.b = make_float4(y, 0.5f + y * y, -2.0f * y, 0.0f);
            tc = make_float4(sm.raw[6][i][j] * A, sm.raw[7][i][j] * k_gd,
                             sm.raw[8][i][j] * k_g0,
                             (sm.raw[5][i][j] / dx) * k_ds);
            win = window_range(f0, c.a.z);
            cr = core_range(f0, c, win);
            keep = (tc.x != 0.0f || tc.y != 0.0f || tc.z != 0.0f ||
                    tc.w != 0.0f) &&
                   win.x <= win.y && kl + win.y >= r_lo && kl + win.x <= r_hi;
          }
          const unsigned bal = __ballot_sync(0xffffffffu, keep);
          if (keep) {
            const int pos = n_kept + __popc(bal & ((1u << lane) - 1u));
            sm.c[i][pos] = c;
            sm.t[i][pos] = tc;
            sm.meta[i][pos] = make_int4(kl + win.x, kl + win.y, kl,
                                        __float_as_int(f0));
            sm.core[i][pos] = make_int2(kl + cr.x, kl + cr.y);
          }
          n_kept += __popc(bal);
        }
        if (lane == 0) sm.n[i] = n_kept;
      }
      __syncthreads();
      if (ch + 1 < n_chunks) issue_params(ch + 1);
      if (ch + 2 < n_chunks) issue_slots(ch + 2);
      cp_async_commit();

      if (warp_live) {
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int n = sm.n[i];
          for (int k = 0; k < n; ++k) {
            const int4 mt = sm.meta[i][k];
            // warp-uniform: does the window meet this warp's points?
            if (mt.y < wk0 || mt.x > wk0 + WPTS - 1) continue;
            const LineConst c = sm.c[i][k];
            const float4 tc = sm.t[i][k];
            const int2 cr = sm.core[i][k];
            const float f0 = __int_as_float(mt.w);
#pragma unroll
            for (int p = 0; p < K3_PPT; ++p) {
              const int a = wk0 + p * 32;
              if (mt.y < a || mt.x > a + 31) continue;
              const float u = static_cast<float>(kg[p] - mt.z) - f0;
              const bool in = u > -c.a.z && u <= c.a.z;
              if (cr.y < a || cr.x > a + 31) {
                // no point of the span in |x| + y < 15: branch-free
                const float v =
                    tangent_term<false, FAST>(u, c, tc, s_wei, n_wei);
                acc[i][p] = in ? acc[i][p] + v : acc[i][p];
              } else if (in) {
                acc[i][p] += tangent_term<true, FAST>(u, c, tc, s_wei,
                                                      n_wei);
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  // every row of the CTA, live or not (a dead row's sums are zeros)
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    if (i < nr) {
#pragma unroll
      for (int p = 0; p < K3_PPT; ++p)
        if (pt_live[p])
          out[static_cast<size_t>(r0 + i) * n_out + kg[p]] = acc[i][p];
    }
  }
}

// ---- K4: the SD-Voigt tangent ----------------------------------------------
//
// Replaces pallas_xsect.py::_make_fused_sdvoigt_jvp_kernel (launcher
// _xsect_fused_sdvoigt_jvp_call, the JVP rule of xsect_fused_sdvoigt_diff):
// the directional derivative of the single-pass sdvoigt pass (K1 sdvoigt,
// zero grid shift) w.r.t. (strength, gamma_d, gamma_0, gamma_2, shift0) by
// the analytic formula of pallas_xsect.py:1382-1421, as written: the clamp
// g2 = max(g2, 1e-4 g0 + 1e-12) passing dg2 above it and 1e-4 dg0 where it
// clamps; S = sqrt(X + c^2) = us + i vs; the CPF points Z1,2 = S -+ c at
// (x, y) = (-vs, us -+ c); dX, dc and dS; dK(Z) = Kx (-Im dZ) + Ky Re dZ.
// (K, Kx, Ky) are the region-consistent derivatives of the Weideman or the
// unguarded asymptotic form, also inside the primal's CPF3 sub-band (JAX's
// kernel takes the blend's slope there; a dual-number K4 would take CPF3's
// and differ from the reference). The point math is the non-contracting
// __f*_rn form in the plain version's order: the w(Z1) - w(Z2) difference
// amplifies rounding, as in K1's SD-Voigt block.
//
// Shape: K3's (direction, layer) rows on K1's skeleton, the row skeleton
// K5 and K6 share (k1_skeleton.cuh::row_skeleton, policy SdRows): one CTA
// per (128-point slice of a tile, 4 rows r = d * n_lay_call + l), four
// warps, each owning one 32-point span of the slice and staging one row. A
// row whose direction has no non-zero tangent on its layer (the wrapper's
// (nd, nLay) table `live`) stages nothing; a CTA without a live row writes
// its zeros and stops; each evaluation updates its row's one direction. The
// tile's slots go through the cp.async ring (slot data two chunks ahead;
// the row's 6 parameters and its direction's 5 tangents one chunk ahead).
// Each staged (slot, row) pair gets its integer window (window_range on the
// capped wing) and is kept, per row in slot order (ballot and prefix
// count), only if one of its direction's tangents is non-zero and the
// window meets the slice. A kept pair's point-independent values are
// computed once then (sd_pair: 1/Gamma2, Re X + c^2, c, strength A and the
// direction's (num_r, dc, shift0_t, g2e_t, strength_t A, gamma_d_t
// sA/gamma_d), the same operations on the same values as the per-point
// form, so hoisting rounds nothing differently), with its Weideman range
// (sd_near_range: a superset of the grid offsets at which a CPF point can
// take the Weideman branch). Each warp tests a kept pair's window against
// its span with a warp-uniform compare; a span wholly outside the pair's
// Weideman range evaluates both CPF points in the asymptotic form,
// branch-free and masked by the window; a span that meets it keeps the
// per-lane region rule (sd_k_grads). A culled pair holds only points whose
// window test fails or whose terms are exact +-0 (its direction's five
// tangents are zero there; adding +-0 to a sum begun at +0 leaves it as it
// is), and a span sent to the asymptotic form holds only points the
// per-lane test sends there, so each (direction, layer, point) adds the
// same terms in slot order as a walk over every slot with every direction:
// the outputs are that walk's bits. Every output is written once by one
// thread: no atomics; the same inputs give bit-identical outputs.
//
// Bound. FP32 issue, as K3 and K6: the inner loop reads shared memory only,
// and an evaluation is hundreds of lane-ops. Hand counts (a*b+c = 2, sqrt
// 3, divide 4, a compare or a select 1, a negation free) per evaluation:
// the window, dnu, xi, S and the denominator (sd_point) 37; per CPF point
// its (K, Kx, Ky) after the 3-op region test (Weideman 49 + 15 n_wei, the
// asymptotic form 38); per live direction its term (sd_term, with K1 - K2)
// and the add, 32. chip_smoke.py counts the evaluations on the host (each
// CPF point by its own region: Z2 = S + c leaves |x| + y < 15 before Z1 =
// S - c) with the evaluation's shared work once per live (pair, point) and
// the term once per live (pair, direction, point), K3's convention, and
// the SASS instructions of each piece (tools/sass.py::k4_eval_instructions)
// for the issue-slot bound.
//
// Occupancy: see K4_MIN_CTAS.
//
// Numerics: float32, IEEE division and square root, no contraction in the
// point math (the __f*_rn wrappers below), but at sd_k_wei's 1/|e|^2 and
// sd_k_asym's 1/|0.5 - z^2|^2, where JAX's kernel calls _rcp(., fast): the
// fast reciprocal in the FAST build (xr).

constexpr int K4_NP = 6;   // shift0, strength, gamma_d, gamma_0, gamma_2, wing
constexpr int K4_NT = 5;   // the tangents of the first five
// Occupancy, chosen by timing each variant against the others in turns
// (kernel_ab.py, the card's kernel time of each pass; PERF.md): a
// register cap for 8 CTAs an SM, at which ptxas takes 62 registers without
// spills (16.5 KB of shared memory a CTA). Uncapped (78 registers, 6
// CTAs) was 2-3% slower on the SD-Voigt OD's passes; a cap for 10 CTAs (48
// registers, 32 bytes of spills) 5-8% slower; 256 threads (8 rows,
// 256-point slices, 4 CTAs) 7-22% slower on the HT Jacobian's 128-point
// tiles; 64 threads (2 rows, 64-point slices) 12% slower.
constexpr int K4_MIN_CTAS = 8;

__device__ __forceinline__ float xm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float xa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float xs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float xd(float a, float b) { return __fdiv_rn(a, b); }
// 1/a at the sites where JAX's K4 calls _rcp(., fast) (_voigt_K_grads):
// the fast reciprocal in a FAST instantiation, else xd(1, a)
template <bool FAST>
__device__ __forceinline__ float xr(float a) {
  if constexpr (FAST)
    return rcp_fast(a);
  else
    return xd(1.0f, a);
}

// (K, Kx, Ky) of the Weideman series, |x| + y < 15, non-contracting
// (fused_xsect.py::_weideman_k_grads)
template <bool FAST>
__device__ __forceinline__ KGrads sd_k_wei(float x, float y, const float* wei,
                                           int n_wei) {
  KGrads g;
  const float L = wei[0];
  const float er = xa(L, y), ei = -x;
  const float inv_e = xr<FAST>(xa(xm(er, er), xm(ei, ei)));
  const float ier = xm(er, inv_e), iei = xm(-ei, inv_e);
  const float nr = xs(L, y), ni = x;
  const float zr = xm(xa(xm(nr, er), xm(ni, ei)), inv_e);
  const float zi = xm(xs(xm(ni, er), xm(nr, ei)), inv_e);
  float pr = wei[1], pi = 0.0f, qr = 0.0f, qi = 0.0f;
  for (int k = 2; k <= n_wei; ++k) {
    const float tqr = xa(xs(xm(qr, zr), xm(qi, zi)), pr);
    qi = xa(xa(xm(qr, zi), xm(qi, zr)), pi);
    qr = tqr;
    const float tpr = xa(xs(xm(pr, zr), xm(pi, zi)), wei[k]);
    pi = xa(xm(pr, zi), xm(pi, zr));
    pr = tpr;
  }
  const float i2r = xs(xm(ier, ier), xm(iei, iei));
  const float i2i = xm(xm(2.0f, ier), iei);
  const float i3r = xs(xm(i2r, ier), xm(i2i, iei));
  const float i3i = xa(xm(i2r, iei), xm(i2i, ier));
  const float i4r = xs(xm(i2r, i2r), xm(i2i, i2i));
  const float i4i = xm(xm(2.0f, i2r), i2i);
  const float c4 = xm(4.0f, L);
  const float Qr = xa(xa(xm(c4, xs(xm(qr, i4r), xm(qi, i4i))),
                         xm(4.0f, xs(xm(pr, i3r), xm(pi, i3i)))),
                      xm(INV_SQRT_PI, i2r));
  const float Qi = xa(xa(xm(c4, xa(xm(qr, i4i), xm(qi, i4r))),
                         xm(4.0f, xa(xm(pr, i3i), xm(pi, i3r)))),
                      xm(INV_SQRT_PI, i2i));
  g.K = xa(xm(2.0f, xs(xm(pr, i2r), xm(pi, i2i))), xm(INV_SQRT_PI, ier));
  g.Kx = -Qi;
  g.Ky = -Qr;
  return g;
}

// (K, Kx, Ky) of the unguarded asymptotic form, non-contracting
// (fused_xsect.py::_asym_k_grads)
template <bool FAST>
__device__ __forceinline__ KGrads sd_k_asym(float x, float y) {
  KGrads g;
  const float dr = xs(xa(0.5f, xm(y, y)), xm(x, x));
  const float di = xm(xm(-2.0f, x), y);
  const float inv = xr<FAST>(xa(xm(dr, dr), xm(di, di)));
  g.K = xm(xm(INV_SQRT_PI, xs(xm(y, dr), xm(x, di))), inv);
  const float nr = xs(xa(0.5f, xm(x, x)), xm(y, y));
  const float ni = -di;
  const float d2r = xs(xm(dr, dr), xm(di, di));
  const float d2i = xm(xm(2.0f, dr), di);
  const float inv2 = xm(inv, inv);
  const float mr = xa(xm(nr, d2r), xm(ni, d2i));
  const float mi = xs(xm(ni, d2r), xm(nr, d2i));
  g.Kx = xm(xm(INV_SQRT_PI, mi), inv2);
  g.Ky = xm(xm(INV_SQRT_PI, mr), inv2);
  return g;
}

// (K, Kx, Ky) by hum1_wei's region rule (fused_xsect.py::_voigt_k_grads)
template <bool FAST>
__device__ __forceinline__ KGrads sd_k_grads(float x, float y,
                                             const float* wei, int n_wei) {
  if (xa(fabsf(x), y) < REGION_BOUND)
    return sd_k_wei<FAST>(x, y, wei, n_wei);
  return sd_k_asym<FAST>(x, y);
}

// A kept (slot, row) pair's point-independent values
struct SdPair {
  float4 a;   // shift0, 1/Gamma2, Re X + c^2 (aa), c
  float4 b;   // strength A, num_r, dc, shift0_t
  float4 t;   // g2e_t, strength_t A, gamma_d_t sA/gamma_d, wingu
};

// From the (layer, line) parameters p (shift0, strength, gamma_d, gamma_0,
// gamma_2) and the row direction's tangents t (of the same five): the
// plain version's per-line algebra (a scalar divided by a tensor being its
// reciprocal times the scalar)
__device__ __forceinline__ SdPair sd_pair(const float* p, const float* t,
                                          float wingu) {
  const float gd = p[2], g0 = p[3], g2r = p[4];
  const float cte = xm(1.0f / gd, SQRT_LN2);
  const float clamp = xa(xm(1e-4f, g0), 1e-12f);
  const float g2 = fmaxf(g2r, clamp);
  const float inv_g2 = 1.0f / g2;
  const float xr = xm(xs(g0, xm(1.5f, g2)), inv_g2);
  const float cc = xm(1.0f / xm(cte, g2), 0.5f);
  const float A = xm(INV_SQRT_PI, cte);
  const float sA = xm(p[1], A);
  const float k_gd = xd(sA, gd);
  const float s0_t = t[0], s_t = t[1], gd_t = t[2], g0_t = t[3];
  const float g2e_t = g2r >= clamp ? t[4] : xm(1e-4f, g0_t);
  const float dXr = xm(inv_g2, xs(g0_t, xm(xa(1.5f, xr), g2e_t)));
  const float dc = xm(cc, xs(xd(gd_t, gd), xm(inv_g2, g2e_t)));
  SdPair q;
  q.a = make_float4(p[0], inv_g2, xa(xr, xm(cc, cc)), cc);
  q.b = make_float4(sA, xa(dXr, xm(xm(2.0f, cc), dc)), dc, s0_t);
  q.t = make_float4(g2e_t, xm(s_t, A), xm(gd_t, k_gd), wingu);
  return q;
}

// Re X + c^2 above this share of R^2 = (15 + c)^2 (the CPF points' Weideman
// boundary near tangency) makes the float32 region test ill-conditioned:
// the pair takes its whole window (sd_near_range)
constexpr float K4_NEAR_P_MAX = 0.9f;

// The grid offsets d - k_line (a superset, within the window range win) at
// which a CPF point of the pair can take hum1_wei's Weideman branch: K5's
// PART4 range (fused_ht.cu::ht_near_range) with c2t and csqrtY = c real.
// S = sqrt(X + c^2) = us + i vs, P = |Re X + c^2| and |Im X| = |shift0 -
// dnu| / Gamma2; Z1 = S - c lies in |Im Z| + Re Z < 15 where us + |vs| <
// R = 15 + c (Z2 = S + c only inside that), and (us + |vs|)^2 = |X + c^2| +
// |Im X| grows with |Im X| from P: below R^2 exactly where |Im X| < (R^4 -
// P^2) / (2 R^2), nowhere if P >= R^2. The radius is widened by 1e-4 of
// itself and a grid step (window_range adds two more), as core_range's.
// Near tangency (P > 0.9 R^2, which large c or the Voigt-limit clamp
// give) the float32 Im S = sqrt((|X + c^2| - P)/2) cancels enough to move
// the test's boundary past that margin: the whole window (NaN likewise).
__device__ __forceinline__ int2 sd_near_range(float f0, const SdPair& q,
                                              float dx, int2 win) {
  const float P = fabsf(q.a.z);
  const float R = REGION_BOUND + q.a.w;
  const float R2 = R * R;
  if (P >= R2 * 1.001f) return make_int2(1, 0);
  if (!(P <= K4_NEAR_P_MAX * R2)) return win;
  const float r = (R2 - P) * (R2 + P) / (2.0f * R2) / (q.a.y * dx);
  const int2 cw = window_range(f0 + q.a.x / dx, r * 1.0001f + 1.0f);
  return make_int2(max(win.x, cw.x), min(win.y, cw.y));
}

// One point's S = sqrt(X + c^2) = us + i vs, Im X and the denominator 2 |S|^2
struct SdPoint {
  float xi, us, vs, den;
};

__device__ __forceinline__ SdPoint sd_point(float u, const SdPair& q,
                                            float dx) {
  const float inv_g2 = q.a.y, aa = q.a.z;
  SdPoint s;
  s.xi = xm(xs(q.a.x, xm(u, dx)), inv_g2);
  const float r = __fsqrt_rn(xa(xm(aa, aa), xm(s.xi, s.xi)));
  s.us = __fsqrt_rn(fmaxf(xm(xa(r, aa), 0.5f), 0.0f));
  const float sv = __fsqrt_rn(fmaxf(xm(xs(r, aa), 0.5f), 0.0f));
  s.vs = s.xi > 0.0f ? sv : (s.xi < 0.0f ? -sv : 0.0f);
  s.den = xm(2.0f, fmaxf(xa(xm(s.us, s.us), xm(s.vs, s.vs)), 1e-30f));
  return s;
}

// The row direction's term of one evaluation, from the two CPF points'
// (K, Kx, Ky)
__device__ __forceinline__ float sd_term(const SdPoint& s, const KGrads& g1,
                                         const KGrads& g2, const SdPair& q) {
  const float num_r = q.b.y, dc = q.b.z;
  const float dK12 = xs(g1.K, g2.K);
  const float dXi = xm(q.a.y, xs(q.b.w, xm(s.xi, q.t.x)));
  const float dSr = xd(xa(xm(num_r, s.us), xm(dXi, s.vs)), s.den);
  const float dSi = xd(xs(xm(dXi, s.us), xm(num_r, s.vs)), s.den);
  const float dK1 = xa(xm(g1.Kx, -dSi), xm(g1.Ky, xs(dSr, dc)));
  const float dK2 = xa(xm(g2.Kx, -dSi), xm(g2.Ky, xa(dSr, dc)));
  return xa(xs(xm(q.t.y, dK12), xm(q.t.z, dK12)), xm(q.b.x, xs(dK1, dK2)));
}

// the (nLay, L) parameter rows and the (n_dir, nLay, L) tangent rows
struct SdPtrs {
  const float* p[K4_NP];
  const float* t[K4_NT];
};

// K4's policy of the row skeleton (k1_skeleton.cuh::row_skeleton)
template <bool FAST>
struct SdRows {
  static constexpr int N_PRM = K4_NP, N_TAN = K4_NT, I_WING = 5;
  static constexpr int MAX_WEI = ::MAX_WEI;
  using Ptrs = SdPtrs;
  struct Kept {
    SdPair pair[ROW_LC][ROW_CH];
  };

  static __device__ __forceinline__ int2 stage(
      Kept& kept, const float (*raw)[ROW_LC][ROW_CH], int i, int j, int pos,
      float f0, float wu, int2 win, float dx) {
    float pv[K4_NP - 1], tv[K4_NT];
#pragma unroll
    for (int e = 0; e < K4_NP - 1; ++e) pv[e] = raw[e][i][j];
#pragma unroll
    for (int e = 0; e < K4_NT; ++e) tv[e] = raw[K4_NP + e][i][j];
    const SdPair q = sd_pair(pv, tv, wu);
    kept.pair[i][pos] = q;
    return sd_near_range(f0, q, dx, win);
  }

  static __device__ __forceinline__ float eval(float sum, const Kept& kept,
                                               int i, int k, float u,
                                               bool pt_live, bool far,
                                               const float* wei, int n_wei,
                                               float dx) {
    const SdPair q = kept.pair[i][k];
    const bool in = pt_live && u > -q.t.w && u <= q.t.w;
    if (far) {
      // no point of the span in a Weideman region: branch-free
      const SdPoint s = sd_point(u, q, dx);
      const KGrads g1 = sd_k_asym<FAST>(-s.vs, xs(s.us, q.a.w));
      const KGrads g2 = sd_k_asym<FAST>(-s.vs, xa(s.us, q.a.w));
      const float v = sd_term(s, g1, g2, q);
      return in ? sum + v : sum;
    }
    if (!in) return sum;
    const SdPoint s = sd_point(u, q, dx);
    const KGrads g1 = sd_k_grads<FAST>(-s.vs, xs(s.us, q.a.w), wei, n_wei);
    const KGrads g2 = sd_k_grads<FAST>(-s.vs, xa(s.us, q.a.w), wei, n_wei);
    return sum + sd_term(s, g1, g2, q);
  }
};

template <bool FAST>
__global__ void __launch_bounds__(ROW_THREADS, K4_MIN_CTAS)
fused_sdvoigt_jvp_kernel(const RowArgs<SdPtrs> args) {
  __shared__ RowSmem<SdRows<FAST>> sm;
  __shared__ float s_wei[MAX_WEI + 1];
  row_skeleton<SdRows<FAST>>(args, sm, s_wei);
}

}  // namespace

// K3's entry: live is the (n_dir, n_lay) int32 table of the directions'
// non-zero tangents per parameter layer; out (n_dir, n_lay_call, n_out)
extern "C" int RADTXFR_ENTRY(radtxfr_fused_xsect_jvp)(
    const void* starts, const void* counts, const void* k_line,
    const void* frac0, const void* line, const void* wcap,
    const void* tile_off, const void* lay_idx, int n_lay_call,
    const void* live,
    const void* shift0, const void* strength, const void* gamma_d,
    const void* gamma_0, const void* wing, const void* shift0_t,
    const void* strength_t, const void* gamma_d_t, const void* gamma_0_t,
    int n_dir, int n_lay, int n_lines, const void* wei, int n_wei, int tile,
    int block, int n_tiles, int n_out, double dx, void* out, void* stream) {
  const long long row_groups =
      (static_cast<long long>(n_dir) * n_lay_call + K3_LC - 1) / K3_LC;
  if (n_wei < 1 || n_wei > MAX_WEI || tile < 1 || block < 1 || n_dir < 1 ||
      row_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_per_tile = (tile + K3_SPAN - 1) / K3_SPAN;
  const dim3 grid(static_cast<unsigned>(n_tiles) * sub_per_tile,
                  static_cast<unsigned>(row_groups));
  if (grid.x == 0 || grid.y == 0) return 0;
  fused_xsect_jvp_kernel<BUILD_FAST><<<grid, THREADS, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const int*>(k_line), static_cast<const float*>(frac0),
      static_cast<const int*>(line), static_cast<const float*>(wcap),
      static_cast<const int*>(tile_off), static_cast<const int*>(lay_idx),
      n_lay_call, static_cast<const int*>(live),
      static_cast<const float*>(shift0),
      static_cast<const float*>(strength), static_cast<const float*>(gamma_d),
      static_cast<const float*>(gamma_0), static_cast<const float*>(wing),
      static_cast<const float*>(shift0_t),
      static_cast<const float*>(strength_t),
      static_cast<const float*>(gamma_d_t),
      static_cast<const float*>(gamma_0_t), n_dir, n_lay, n_lines,
      static_cast<const float*>(wei), n_wei, tile, block, sub_per_tile, n_out,
      static_cast<float>(dx), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K4's entry: live is the launch's (n_dir, n_lay) int32 table of the
// directions' non-zero tangents per parameter layer; out (n_dir,
// n_lay_call, n_out)
extern "C" int RADTXFR_ENTRY(radtxfr_fused_sdvoigt_jvp)(
    const void* starts, const void* counts, const void* k_line,
    const void* frac0, const void* line, const void* wcap,
    const void* tile_off, const void* lay_idx, int n_lay_call,
    const void* live,
    const void* shift0, const void* strength, const void* gamma_d,
    const void* gamma_0, const void* gamma_2, const void* wing,
    const void* shift0_t, const void* strength_t, const void* gamma_d_t,
    const void* gamma_0_t, const void* gamma_2_t, int n_dir, int n_lay,
    int n_lines, const void* wei, int n_wei, int tile, int block, int n_tiles,
    int n_out, double dx, void* out, void* stream) {
  const SdPtrs ptr = {
      {static_cast<const float*>(shift0), static_cast<const float*>(strength),
       static_cast<const float*>(gamma_d), static_cast<const float*>(gamma_0),
       static_cast<const float*>(gamma_2), static_cast<const float*>(wing)},
      {static_cast<const float*>(shift0_t),
       static_cast<const float*>(strength_t),
       static_cast<const float*>(gamma_d_t),
       static_cast<const float*>(gamma_0_t),
       static_cast<const float*>(gamma_2_t)}};
  return row_launch<SdRows<BUILD_FAST>>(
      fused_sdvoigt_jvp_kernel<BUILD_FAST>, starts, counts, k_line, frac0,
      line, wcap, tile_off, lay_idx, n_lay_call, live, ptr, n_dir, n_lay,
      n_lines, wei, n_wei, tile, block, n_tiles, n_out, dx, out, stream);
}
