// K1: bucketed layered line-shape accumulation for Hopper (sm_90a), and
// K7, the unfused kernel of the prebuilt-plan route (below K1, sharing its
// per-point code).
//
// Replaces radtxfr_tpu/kernels/pallas_xsect.py::_make_fused_kernel (launcher
// _xsect_fused_call, entry xsect_pallas(fused_layers=True)) in all of its
// modes:
//   asym   guarded Humlicek asymptotic Re w (the far-wing pass);
//   core   Weideman - guarded asym inside |x| + y < 15;
//   mix    unguarded K/L blend scaled by K + Y L (line mixing);
//   full   the single-pass hum1_wei blend (Weideman inside |x| + y < 15, the
//          UNGUARDED asymptotic form outside, pallas_xsect.py::_voigt_wr);
//   sdvoigt, sdvoigt_asym, sdvoigt_core
//          hapi's pcqsdhc with Gamma2 real (pallas_xsect.py::_sdvoigt_block):
//          the exact CPF3-vs-CPF selection, both CPF points in the guarded
//          asymptotic form, and their difference;
//   lorentz, doppler
//          hapi's simple forms with its truncated constants
//          (pallas_xsect.py::_simple_profile);
//   corr:R:{voigt,voigtfull,sdvoigt,sdvoigtfull}
//          the coarse-far correction (pallas_xsect.py:762-879): the masked
//          point term minus the 4-point Lagrange-cubic interpolation of the
//          masked guarded-asymptotic node values, nodes every R grid points
//          with node row 0 one coarse step left of the tile start.
// For each nu-tile i and layer l it computes
//     out[l, i*tile + k] = sum over the tile's packed line slots of
//                          mask(u) * f_mode(u)        (corr: - interp(k)),
//     u = (k_grid - k_line) - frac0   (int32 difference, then float),
// with hapi's window mask -wingu < u <= wingu. The correction passes mask by
// the TRUE window (wing / dx, no wing cap): their plans place lines only
// near their centres and at their window edges.
//
// Shape. One CTA per (256-point slice of a tile, chunk of LC layers): two
// warps, each owning 128 consecutive points of the slice (a lane its points
// p*32 + lane, so every store is coalesced and each 32-point span is one
// warp-uniform range). The CTA walks its tile's blocks [starts[i],
// starts[i] + counts[i]) in chunks of KCH slots through a three-stage
// pipeline in shared memory: cp.async copies each chunk's slot data (grid
// index, fraction, line, wing cap) two chunks ahead and its scattered
// per-(line, layer) parameters one chunk ahead, so those loads overlap the
// evaluation of the chunk before. Per staged (slot, layer) pair the CTA
// computes the eight constants the evaluation needs (two float4) and the
// pair's integer window [k_line + floor(frac0 - wingu) - 2, k_line +
// ceil(frac0 + wingu) + 2] (a superset of the indices the float window test
// can pass), intersects it with the slice's points and keeps, per layer and
// in slot order (warp ballot and prefix count), only the pairs that meet
// them. Each warp then tests a kept pair against its 128 points and each of
// its four 32-point spans with one warp-uniform integer compare before its
// lanes evaluate: the production asym tiles are four slices wide and the
// windows narrow, so 40-60% of the staged pairs miss the slice (host count
// on the derived list), and in the core pass ~70% of the kept pairs' spans
// miss their window. A
// skipped pair or span holds only points whose window test fails, whose
// terms were never added: each point adds the same terms in the same order
// as a walk over every slot, and the outputs are the same bits. Where
// a tile holds more than SPLIT_SLOTS line slots (350 cm^-1 windows put
// thousands of lines on every point, and one running float32 sum over them
// drifts by a few 1e-6 of the peak: measured 2.9e-6 against the plain
// version), each chunk's sum is kept apart before it joins the total (a
// two-level sum, SPLIT); the narrow-window passes of the OD path (at most
// 1,920 slots a tile at production width) keep one running sum, whose 16
// extra registers would cost them ~10% (spills).
// Every output is written once by one thread, in a fixed order: no atomics,
// and the same inputs give bit-identical outputs. A correction pass (the
// same kernel, CORR) also evaluates, per kept (slot, layer), the slice's
// node values once (256/R + 3 of them, so R must divide 256; R >= 8 bounds
// the shared buffer), keeps the pairs whose window meets the slice's node
// rows, and each point interpolates its four with FP32 FMAs:
// no tensor cores (the TPU kernel needed Precision.HIGHEST for the same
// product).
//
// Packed parameters. The Pallas wrapper materialises packed
// (n_blocks, nLay, block) parameter copies through the plan's gather
// (pallas_xsect.py:332-344); at full width those run to hundreds of MB per
// call. This kernel instead reads the plan's per-slot global line index
// (`line`, -1 = padding) and indexes the (nLay, L) parameter rows directly
// while staging.
//
// Bound. Hand counts of pallas_xsect.py::_ops_per_eval at n_weideman = 16:
// 28 lane-ops per evaluation for asym, 175 for core, 190 for mix and 173
// for full (_flops_per_eval(16, "full"), the XLA scheduler's estimate, says
// 168). Those count both region forms, as the Pallas kernel evaluates both
// and selects; here the region test branches per point, so an evaluation
// outside |x| + y < 15 costs the asymptotic form only (about 31 lane-ops in
// full: the 11-op prelude, the 3-op region test, the 16-op unguarded form
// and the accumulate) and Weideman runs only where some lane of a warp lies
// in the core. SD-Voigt, with the Pallas count's conventions (one op per
// elementwise operation, a*b+c = 2, sqrt 3, divide 4, exp 6) and building
// blocks (pallas_xsect.py:1518-1558, y elementwise), per evaluation:
//   PRE 11 (grid offset, window mask, accumulate), the SD prelude 24 (dnu,
//   xi, the complex square root u + iv, x12/y1/y2) and the tail 2
//   (w1 - w2, scale) in every SD mode;
//   sdvoigt_asym: + 2 x 19 (the guarded asymptotic form at both CPF
//   points) = 75, JAX's count;
//   sdvoigt: + 22 (|Z1|, |Z2|, the CPF3 test and its selects) + per CPF
//   point the branch it takes: CPF3 168, or the 3-op region test plus
//   Weideman 35 + 7n (150 at n = 16) or plus the unguarded asymptotic form
//   18 (21); sdvoigt_core: + 2 x 20 (the guarded form subtracted).
// JAX evaluates all three branches at both points (57 + 2 (227 + 7n) = 735,
// 775 for sdvoigt_core); this kernel branches per point, so chip_smoke.py
// counts each CPF point of an evaluation at Weideman's price inside the
// exact radius where that point lies in |x| + y < 15 (Z2 = S + c leaves it
// before Z1 = S - c) and at the asymptotic form's outside it (59 + 2 x 21 =
// 101 to 59 + 2 x 150 = 359; core + 40). lorentz 18, doppler 20 (exp at 6).
// A correction evaluation is its point term plus the 9-op interpolation
// (four FMAs and the subtraction), plus (256/R + 3) node terms per (slot,
// layer) shared by the slice's 256 points. Each evaluation reads two float4
// from shared memory (amortised over the PPT points of a thread) and nothing
// from device memory; the staged constants cost ~6 scattered global loads per
// (slot, layer), shared by the 256 points of the slice. So every mode is
// bound by FP32 issue (and, for asym, by the IEEE reciprocal's
// multi-instruction sequence), not by bytes: registers hold the LC x PPT
// accumulators and the inner loop touches no device memory. The branch on
// the window mask (and, in core, mix and full, on the region) skips
// evaluations whose contribution the Pallas kernel computes and then
// discards; chip_smoke.py recounts the in-window (and in-core) evaluations
// of each pass on the host and states each mode's bound from them, both in
// the operations above and in issue slots: the SASS instructions of a
// point in asym, core, mix and full, counted from this file's build
// (tools/sass.py: asym 31.5 a point in its window, 6.25 a point whose
// window test fails; PERF.md).
//
// Numerics follow the Pallas kernel op for op, in float32: dx*cte, g0*cte
// and strength*(1/sqrt(pi)*cte) per (line, layer); IEEE division and square
// root everywhere (the TPU path's approximate reciprocal plus Newton step is
// not carried over; do not build with --use_fast_math). nvcc contracts
// a*b+c into FMA, a float-rounding-level difference from XLA, except in the
// SD-Voigt block: its w(Z1) - w(Z2) difference amplifies each evaluation's
// rounding 20-50x, so that block is written with the non-contracting
// __f*_rn intrinsics in the plain PyTorch version's order of operations.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;            // threads per CTA
constexpr int PPT = 4;                 // grid points per thread
constexpr int SPAN = THREADS * PPT;    // points per CTA
constexpr int LC = 4;                  // layers per CTA
constexpr int CH = 64;                 // line slots K7 stages per step
constexpr int KCH = 32;                // ... K1 (a warp's ballot each)
constexpr int SPLIT_SLOTS = 2048;      // a tile's slots that take SPLIT
constexpr int MIN_R = 8;               // smallest correction R
constexpr int MAX_WEI = 32;            // Weideman terms at most

constexpr float SQRT_LN2 = static_cast<float>(0.8325546111576977);
constexpr float INV_SQRT_PI = static_cast<float>(0.5641895835477563);
constexpr float INV_PI = static_cast<float>(0.3183098861837907);
// hapi's truncated constants (core/constants.py: LN2,
// SQRT_LN2_DIV_SQRT_PI), used by the Doppler form
constexpr float LN2_HAPI = static_cast<float>(0.6931471805599);
constexpr float SQRT_LN2_DIV_SQRT_PI = static_cast<float>(
    0.469718639319144059835);
constexpr float REGION_BOUND = 15.0f;
constexpr float GUARD = 0.25f;

// the order of radtxfr_tpu_torch/kernels/fused_xsect.py: MODES, then
// CORR_VARIANTS
enum Mode {
  ASYM = 0, CORE, MIX, FULL, SDV, SDV_ASYM, SDV_CORE, LORENTZ, DOPPLER,
  CORR_VOIGT, CORR_VOIGTFULL, CORR_SDV, CORR_SDVFULL
};

__host__ __device__ constexpr bool is_sd(int m) {
  return m == SDV || m == SDV_ASYM || m == SDV_CORE || m == CORR_SDV ||
         m == CORR_SDVFULL;
}

__host__ __device__ constexpr bool is_corr(int m) { return m >= CORR_VOIGT; }

// Staged per-(line, layer) constants, by family:
//   Voigt    a = (ds, xs, wingu, scale), b = (y, 0.5 + y*y, -2*y, Y_mix)
//   SD-Voigt a = (s0, 1/Gamma2, wingu, strength), b = (a_sd, c, cte/sqrt(pi), 0)
//   Lorentz  a = (ds, dx, wingu, strength*g0), b = (g0*g0, 0, 0, 0)
//   Doppler  a = (ds, dx, wingu, strength*K/gd), b = (1/gd, 0, 0, 0)
struct LineConst {
  float4 a;
  float4 b;
};

// non-contracting float operations (the SD-Voigt block)
__device__ __forceinline__ float xm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float xa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float xs(float a, float b) { return __fsub_rn(a, b); }

template <int MODE>
__device__ __forceinline__ LineConst line_const(float shift0, float strength,
                                                float gd, float g0, float g2,
                                                float wingu, float ymix,
                                                float dx) {
  LineConst c;
  if (is_sd(MODE)) {
    // the plain version's per-line algebra (fused_xsect.py::_sdvoigt_block,
    // a scalar divided by a tensor being its reciprocal times the scalar);
    // a runtime-vanishing Gamma2 is clamped to the Voigt limit
    const float cte = xm(1.0f / gd, SQRT_LN2);
    const float g2c = fmaxf(g2, xa(xm(1e-4f, g0), 1e-12f));
    const float inv_g2 = 1.0f / g2c;
    const float c0tr = xm(xs(g0, xm(1.5f, g2c)), inv_g2);
    const float csd = xm(1.0f / xm(cte, g2c), 0.5f);
    c.a = make_float4(shift0, inv_g2, wingu, strength);
    c.b = make_float4(xa(c0tr, xm(csd, csd)), csd, xm(cte, INV_SQRT_PI), 0.0f);
  } else if (MODE == LORENTZ) {
    c.a = make_float4(shift0 / dx, dx, wingu, strength * g0);
    c.b = make_float4(g0 * g0, 0.0f, 0.0f, 0.0f);
  } else if (MODE == DOPPLER) {
    const float inv_gd = 1.0f / gd;
    c.a = make_float4(shift0 / dx, dx, wingu,
                      (strength * SQRT_LN2_DIV_SQRT_PI) * inv_gd);
    c.b = make_float4(inv_gd, 0.0f, 0.0f, 0.0f);
  } else {
    const float cte = SQRT_LN2 / gd;
    const float y = g0 * cte;
    c.a = make_float4(shift0 / dx, dx * cte, wingu,
                      strength * (INV_SQRT_PI * cte));
    c.b = make_float4(y, 0.5f + y * y, -2.0f * y, ymix);
  }
  return c;
}

// Humlicek region-1 asymptotic Re w with the denominator clamp
// (pallas_xsect.py::_asym_re_w, guard = 0.25), y per line.
__device__ __forceinline__ float asym_re_w(float x, const float4& b) {
  const float dr = b.y - x * x;        // 0.5 + y^2 - x^2
  const float di = b.z * x;            // -2 x y
  const float dmag = fmaxf(dr * dr + di * di, GUARD);
  return INV_SQRT_PI * (b.x * dr - x * di) * (1.0f / dmag);
}

// Weideman rational series w = 2 P(Z)/(L - iz)^2 + (1/sqrt(pi))/(L - iz),
// Z = (L + iz)/(L - iz); wei = [L, a_0 .. a_{n-1}] (faddeeva.weideman_coeffs).
template <bool WANT_IM>
__device__ __forceinline__ void weideman_w(float x, float y,
                                           const float* wei, int n_wei,
                                           float* re, float* im) {
  const float L = wei[0];
  const float nr = L - y, ni = x;
  const float er = L + y, ei = -x;
  const float inv_e = 1.0f / (er * er + ei * ei);
  const float zr = (nr * er + ni * ei) * inv_e;
  const float zi = (ni * er - nr * ei) * inv_e;
  float pr = wei[1], pi = 0.0f;
  for (int k = 2; k <= n_wei; ++k) {
    const float t = pr * zr - pi * zi + wei[k];
    pi = pr * zi + pi * zr;
    pr = t;
  }
  const float sr = er * er - ei * ei;
  const float si = 2.0f * er * ei;
  const float inv_s = 1.0f / (sr * sr + si * si);
  *re = 2.0f * (pr * sr + pi * si) * inv_s + INV_SQRT_PI * er * inv_e;
  if (WANT_IM)
    *im = 2.0f * (pi * sr - pr * si) * inv_s - INV_SQRT_PI * ei * inv_e;
}

// ---- the SD-Voigt block, non-contracting, in the plain version's order ----

// guarded (guard = 0.25) or unguarded asymptotic Re w at an elementwise y
__device__ __forceinline__ float asym_x(float x, float y, bool guard) {
  const float dr = xs(xa(0.5f, xm(y, y)), xm(x, x));
  const float di = xm(xm(-2.0f, x), y);
  float dmag = xa(xm(dr, dr), xm(di, di));
  if (guard) dmag = fmaxf(dmag, GUARD);
  return xm(xm(INV_SQRT_PI, xs(xm(y, dr), xm(x, di))), 1.0f / dmag);
}

__device__ __forceinline__ float weideman_x(float x, float y,
                                            const float* wei, int n_wei) {
  const float L = wei[0];
  const float nr = xs(L, y), ni = x;
  const float er = xa(L, y), ei = -x;
  const float inv_e = 1.0f / xa(xm(er, er), xm(ei, ei));
  const float zr = xm(xa(xm(nr, er), xm(ni, ei)), inv_e);
  const float zi = xm(xs(xm(ni, er), xm(nr, ei)), inv_e);
  float pr = wei[1], pi = 0.0f;
  for (int k = 2; k <= n_wei; ++k) {
    const float t = xa(xs(xm(pr, zr), xm(pi, zi)), wei[k]);
    pi = xa(xm(pr, zi), xm(pi, zr));
    pr = t;
  }
  const float sr = xs(xm(er, er), xm(ei, ei));
  const float si = xm(xm(2.0f, er), ei);
  const float inv_s = 1.0f / xa(xm(sr, sr), xm(si, si));
  return xa(xm(xm(2.0f, xa(xm(pr, sr), xm(pi, si))), inv_s),
            xm(xm(INV_SQRT_PI, er), inv_e));
}

// Re w of hapi's 15-term asymptotic CPF (cpf3; pallas_xsect.py::_cpf3_pair),
// |z|^2 clamped at 9
__device__ __forceinline__ float cpf3_x(float x, float y) {
  const float m = fmaxf(xa(xm(x, x), xm(y, y)), 9.0f);
  const float ar = x / m;
  const float ai = (-y) / m;
  const float m2r = xs(xm(ar, ar), xm(ai, ai));
  const float m2i = xm(xm(2.0f, ar), ai);
  float sr = 1.0f, si = 0.0f, tr = 1.0f, ti = 0.0f;
#pragma unroll
  for (int k = 0; k < 15; ++k) {
    const float tt = 0.5f + static_cast<float>(k);
    const float ntr = xm(xs(xm(tr, m2r), xm(ti, m2i)), tt);
    ti = xm(xa(xm(tr, m2i), xm(ti, m2r)), tt);
    tr = ntr;
    sr = xa(sr, tr);
    si = xa(si, ti);
  }
  return xm(-xa(xm(ar, si), xm(ai, sr)), INV_SQRT_PI);
}

// hum1_wei's region rule (pallas_xsect.py::_re_w_select)
__device__ __forceinline__ float select_x(float x, float y, const float* wei,
                                          int n_wei) {
  return xa(fabsf(x), y) < REGION_BOUND ? weideman_x(x, y, wei, n_wei)
                                        : asym_x(x, y, false);
}

enum SdVariant { SD_FULL = 0, SD_ASYM, SD_CORE };

// strength * SD-Voigt profile at grid offset u (the grid shift is zero;
// the shift s0 rides inside the profile)
template <int V>
__device__ __forceinline__ float sdvoigt(float u, const LineConst& c,
                                         float dx, const float* wei,
                                         int n_wei) {
  const float dnu = xm(u, dx);
  const float xi = xm(xs(c.a.x, dnu), c.a.y);
  const float aa = c.b.x;
  const float r = sqrtf(xa(xm(aa, aa), xm(xi, xi)));
  const float uu = sqrtf(fmaxf(xm(xa(r, aa), 0.5f), 0.0f));
  const float sv = sqrtf(fmaxf(xm(xs(r, aa), 0.5f), 0.0f));
  const float v = xi > 0.0f ? sv : (xi < 0.0f ? -sv : 0.0f);  // sign(xi) sv
  const float x12 = -v;
  const float y1 = xs(uu, c.b.y);
  const float y2 = xa(uu, c.b.y);
  float w1, w2;
  if (V == SD_ASYM) {
    w1 = asym_x(x12, y1, true);
    w2 = asym_x(x12, y2, true);
  } else {
    const float sz1 = sqrtf(xa(xm(v, v), xm(y1, y1)));
    const float sz2 = sqrtf(xa(xm(v, v), xm(y2, y2)));
    const bool use3 = fabsf(xs(sz1, sz2)) <= 1.0f && fmaxf(sz1, sz2) > 8.0f &&
                      fminf(sz1, sz2) <= 8.0f;
    w1 = use3 ? cpf3_x(x12, y1) : select_x(x12, y1, wei, n_wei);
    w2 = use3 ? cpf3_x(x12, y2) : select_x(x12, y2, wei, n_wei);
    if (V == SD_CORE) {
      w1 = xs(w1, asym_x(x12, y1, true));
      w2 = xs(w2, asym_x(x12, y2, true));
    }
  }
  return xm(c.a.w, xm(c.b.z, xs(w1, w2)));
}

// unguarded asymptotic Re w (pallas_xsect.py::_voigt_wr, mode 'full')
__device__ __forceinline__ float far_re_w(float x, float y, const float4& b) {
  const float dr = b.y - x * x;
  const float di = b.z * x;
  return INV_SQRT_PI * (y * dr - x * di) * (1.0f / (dr * dr + di * di));
}

// unguarded asymptotic K and L (pallas_xsect.py::_voigt_w_KL)
__device__ __forceinline__ void far_kl(float x, float y, const float4& b,
                                       float* K, float* Lw) {
  const float dr = b.y - x * x;
  const float di = b.z * x;
  const float inv = INV_SQRT_PI * (1.0f / (dr * dr + di * di));
  *K = (y * dr - x * di) * inv;
  *Lw = -(x * dr + y * di) * inv;
}

// a Voigt mode's masked-in contribution at grid offset u before the line's
// scale c.a.w (eval multiplies; K1's asym adds c.a.w * value to its sum
// with one FMA)
template <int MODE>
__device__ __forceinline__ float voigt_value(float u, const LineConst& c,
                                             const float* wei, int n_wei) {
  const float x = (u - c.a.x) * c.a.y;
  const float y = c.b.x;
  if (MODE == ASYM) return asym_re_w(x, c.b);
  const bool in_core = fabsf(x) + y < REGION_BOUND;
  if (MODE == CORE) {
    if (!in_core) return 0.0f;
    float re, im;
    weideman_w<false>(x, y, wei, n_wei, &re, &im);
    return re - asym_re_w(x, c.b);
  }
  if (MODE == FULL) {
    float re, im;
    if (in_core)
      weideman_w<false>(x, y, wei, n_wei, &re, &im);
    else
      re = far_re_w(x, y, c.b);
    return re;
  }
  float K, Lw;
  if (in_core)
    weideman_w<true>(x, y, wei, n_wei, &K, &Lw);
  else
    far_kl(x, y, c.b, &K, &Lw);
  return K + c.b.w * Lw;
}

// the Lorentz or Doppler shape at grid offset u before the line's scale
// c.a.w
template <int MODE>
__device__ __forceinline__ float ld_value(float u, const LineConst& c) {
  const float x = (u - c.a.x) * c.a.y;
  if (MODE == LORENTZ) return INV_PI * (1.0f / (c.b.x + x * x));
  const float t = x * c.b.x;
  return expf((-LN2_HAPI * t) * t);
}

// the masked-in contribution of one slot at grid offset u (all modes but
// the correction passes)
template <int MODE>
__device__ __forceinline__ float eval(float u, const LineConst& c,
                                      const float* wei, int n_wei, float dx) {
  if (MODE == SDV) return sdvoigt<SD_FULL>(u, c, dx, wei, n_wei);
  if (MODE == SDV_ASYM) return sdvoigt<SD_ASYM>(u, c, dx, wei, n_wei);
  if (MODE == SDV_CORE) return sdvoigt<SD_CORE>(u, c, dx, wei, n_wei);
  if (MODE == LORENTZ || MODE == DOPPLER) return c.a.w * ld_value<MODE>(u, c);
  const float r = voigt_value<MODE>(u, c, wei, n_wei);
  // core: a point outside |x| + y < 15 adds an exact 0, not c.a.w * 0
  // (so the add is not contracted with the scale)
  if (MODE == CORE) return r == 0.0f ? 0.0f : c.a.w * r;
  return c.a.w * r;
}

// a correction pass's node term: the guarded asymptotic far field the
// coarse pass evaluated
template <int MODE>
__device__ __forceinline__ float corr_node(float u, const LineConst& c,
                                           float dx, const float* wei,
                                           int n_wei) {
  if (is_sd(MODE)) return sdvoigt<SD_ASYM>(u, c, dx, wei, n_wei);
  return c.a.w * asym_re_w((u - c.a.x) * c.a.y, c.b);
}

// ... and its point term: the node form, or the exact blend for '*full'
template <int MODE>
__device__ __forceinline__ float corr_point(float u, const LineConst& c,
                                            float dx, const float* wei,
                                            int n_wei) {
  if (MODE == CORR_SDVFULL) return sdvoigt<SD_FULL>(u, c, dx, wei, n_wei);
  if (MODE == CORR_VOIGTFULL) {
    const float x = (u - c.a.x) * c.a.y;
    if (fabsf(x) + c.b.x < REGION_BOUND) {
      float re, im;
      weideman_w<false>(x, c.b.x, wei, n_wei, &re, &im);
      return c.a.w * re;
    }
    return c.a.w * asym_re_w(x, c.b);
  }
  return corr_node<MODE>(u, c, dx, wei, n_wei);
}

// Stage slots [c0, c0 + nc) of a block for K7 (unfused_xsect_kernel): grid
// positions and, per layer, the line constants (padding slots filled as the
// Pallas wrapper pads them, never in-window). CAP: clamp the wing to the
// plan's cap.
template <int MODE, int NCH, bool CAP>
__device__ __forceinline__ void stage(
    int c0, int nc, int slot0, int nl, int l0, int tid,
    const int* __restrict__ k_line, const float* __restrict__ frac0,
    const int* __restrict__ line, const float* __restrict__ wcap,
    const int* __restrict__ lay_idx, const float* __restrict__ shift0,
    const float* __restrict__ strength, const float* __restrict__ gamma_d,
    const float* __restrict__ gamma_0, const float* __restrict__ wing,
    const float* __restrict__ ymix, const float* __restrict__ gamma_2,
    int n_lines, float dx, LineConst (*s_c)[NCH], int* s_k, float* s_f) {
  for (int j = tid; j < nc; j += THREADS) {
    s_k[j] = k_line[slot0 + c0 + j];
    s_f[j] = frac0[slot0 + c0 + j];
  }
  for (int i = tid; i < nl * nc; i += THREADS) {
    const int l = i / nc;
    const int j = i - l * nc;
    const int s = slot0 + c0 + j;
    const int g = line[s];
    if (g >= 0) {
      const size_t off = static_cast<size_t>(lay_idx[l0 + l]) * n_lines + g;
      const float w = CAP ? fminf(wing[off], wcap[s]) : wing[off];
      s_c[l][j] = line_const<MODE>(
          shift0[off], strength[off], gamma_d[off], gamma_0[off],
          is_sd(MODE) ? gamma_2[off] : 1.0f, w / dx,
          MODE == MIX ? ymix[off] : 0.0f, dx);
    } else {
      s_c[l][j] = line_const<MODE>(0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f,
                                   MODE == MIX ? 1.0f : 0.0f, dx);
    }
  }
}

// ---- K1's staging pipeline: cp.async, window culling, compaction ----

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

// core adds only inside hum1_wei's |x| + y < 15, x = (d - frac0 - ds) xs
// (outside it adds an exact 0): the indices |d - (frac0 + ds)| < (15 - y)
// / xs, widened by 1e-4 of the radius and a grid step, intersected with the
// window; empty (lo > hi) where y >= 15
__device__ __forceinline__ int2 core_range(float f0, const LineConst& c,
                                           int2 win) {
  const float r = (REGION_BOUND - c.b.x) / c.a.y;
  if (!(r > 0.0f)) return make_int2(1, 0);
  const int2 cw = window_range(f0 + c.a.x, r * 1.0001f + 1.0f);
  return make_int2(max(win.x, cw.x), min(win.y, cw.y));
}

// A K1 CTA's shared memory: a ring of three chunks of slot data (grid
// index, fraction, line, wing cap), copied two chunks ahead; the raw
// per-(layer, slot) parameters of the next chunk, copied one chunk ahead;
// and this chunk's surviving (layer, slot) pairs, compacted per layer in
// slot order: their constants and (window lo, hi, k_line, frac0 bits).
constexpr int RING = 3;
constexpr int NRAW = 6;   // shift0, strength, gamma_d, gamma_0, wing, extra
template <int NCH>
struct K1Smem {
  int k[RING][NCH];
  float f[RING][NCH];
  int line[RING][NCH];
  float cap[RING][NCH];
  float raw[NRAW][LC][NCH];
  LineConst c[LC][NCH];
  int4 meta[LC][NCH];
  int n[LC];
};

// One CTA per (256-point slice of a tile, LC layers): two warps, each
// owning 128 consecutive points of the slice, a lane its points
// warp*128 + p*32 + lane (p < PPT). The tile's slots are walked in chunks
// of NCH. Each staged (slot, layer) pair's integer window is intersected
// with the CTA's points (a correction pass: with its node rows) and only the
// pairs that meet it are kept, in slot order; each warp then tests a kept
// pair's window against its 128 points and each 32-point span with one
// warp-uniform integer compare before its lanes evaluate. A culled pair or
// span held only points outside the window, whose terms were never added,
// so every point adds the same terms in the same order as a walk over
// every slot. asym, lorentz and doppler, whose kept pairs are nearly all
// in their window, evaluate a warp's four points without a branch and add
// c.a.w * the shape (voigt_value, ld_value) with one FMA (the contraction
// the compiler chose for the slot walk; a masked point adds c.a.w * 0), so
// their four chains interleave. A SPLIT sum keeps each 64-slot group's
// sum apart (two chunks; a correction pass's 32-slot chunk), as the slot
// walk did. A correction pass (pallas_xsect.py:762-879) masks by the true
// window, evaluates the slice's node values once per kept (layer, slot)
// into dynamic shared memory (LC * KCH * (SPAN/R + 3) floats) and adds,
// per point, the point term minus the cubic interpolation of its four
// nodes; it always keeps per-chunk sums (SPLIT).
//
// Occupancy: 10.8 KB of static shared memory a CTA (plus 3.6 KB of nodes
// at R = 64); k1_min_ctas caps the registers for 16 CTAs an SM (the Voigt
// modes: 64 registers), 18 (core and the SD-Voigt modes: 56) or 13 (a
// correction pass: 72), 26-36 warps, where shared memory alone let ptxas
// take 96 registers and hold 10, slower than the slot walk's 45-70
// registers (PERF.md)
template <int MODE>
__host__ __device__ constexpr int k1_min_ctas() {
  return is_corr(MODE) ? 13 : is_sd(MODE) ? 18 : MODE == CORE ? 18 : 16;
}

template <int MODE, bool SPLIT>
__global__ void __launch_bounds__(THREADS, k1_min_ctas<MODE>())
fused_xsect_kernel(const int* __restrict__ starts,
                   const int* __restrict__ counts,
                   const int* __restrict__ k_line,
                   const float* __restrict__ frac0,
                   const int* __restrict__ line,
                   const float* __restrict__ wcap,
                   const int* __restrict__ lay_idx, int n_lay_call,
                   const float* __restrict__ shift0,
                   const float* __restrict__ strength,
                   const float* __restrict__ gamma_d,
                   const float* __restrict__ gamma_0,
                   const float* __restrict__ wing,
                   const float* __restrict__ ymix,
                   const float* __restrict__ gamma_2, int n_lines,
                   const float* __restrict__ wei_g, int n_wei, int R, int tile,
                   int block, int sub_per_tile, int n_out, float dx,
                   float* __restrict__ out) {
  constexpr bool CORR = is_corr(MODE);
  static_assert(SPLIT || !CORR, "a correction pass keeps per-chunk sums");
  constexpr int NCH = KCH;
  // a warp's four points without a branch between them
  constexpr bool DENSE = MODE == ASYM || MODE == LORENTZ || MODE == DOPPLER;
  // SPLIT: slots whose sum is kept apart
  constexpr int GROUP = CORR ? KCH : 2 * KCH;
  constexpr int NWARP = THREADS / 32;
  constexpr int WPTS = 32 * PPT;         // points of a warp
  constexpr int LPW = LC / NWARP;        // layers each warp stages
  static_assert(SPAN == NWARP * WPTS && LC % NWARP == 0 && NCH % 32 == 0,
                "two warps of 128 points, LC layers split between them");
  // the raw parameter beyond the five every mode reads
  constexpr bool EXTRA = MODE == MIX || is_sd(MODE);
  __shared__ K1Smem<NCH> sm;
  __shared__ float s_wei[MAX_WEI + 1];
  // the correction pass's node values of each kept (layer, slot): rows of
  // SPAN/R + 3
  extern __shared__ float s_nv[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile_i = blockIdx.x / sub_per_tile;
  const int sub = blockIdx.x - tile_i * sub_per_tile;
  const int l0 = blockIdx.y * LC;
  const int nl = min(LC, n_lay_call - l0);
  const int t0 = tile_i * tile;
  // a slice past the grid's end (the last tile of a short grid) has no
  // output: the whole CTA leaves
  if (t0 + sub * SPAN >= n_out) return;

  if (MODE != ASYM) {
    for (int i = tid; i <= n_wei; i += THREADS) s_wei[i] = wei_g[i];
  }

  // CORR: the slice's node rows; point kloc of the tile takes rows
  // kloc/R .. kloc/R + 3, row m at grid index t0 + (m - 1)*R
  const int kloc0 = sub * SPAN;
  const int last = min(kloc0 + SPAN, tile) - 1;
  const int row0 = CORR ? kloc0 / R : 0;
  const int n_nodes = CORR ? last / R - row0 + 4 : 0;
  const int nv_row = CORR ? SPAN / R + 3 : 0;
  // the grid indices whose windows matter to this CTA: its points, or a
  // correction pass's node rows (which enclose its points)
  const int r_lo = CORR ? t0 + (row0 - 1) * R : t0 + kloc0;
  const int r_hi = CORR ? t0 + (row0 + n_nodes - 2) * R
                        : min(t0 + last, n_out - 1);
  // a point's four nodes lie within 2R of it: a span check's reach
  const int reach = CORR ? 2 * R : 0;
  const int wk0 = t0 + kloc0 + warp * WPTS;   // this warp's first point
  const bool warp_live = kloc0 + warp * WPTS <= last && wk0 < n_out;

  int kg[PPT], seg[PPT];
  bool live[PPT];
  float w[PPT][4];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int kloc = kloc0 + warp * WPTS + p * 32 + lane;
    kg[p] = t0 + kloc;
    live[p] = kloc < tile && kg[p] < n_out;
    if constexpr (CORR) {
      const int ks = min(kloc, last);
      const int sg = ks / R;
      seg[p] = sg - row0;
      // uniform 4-point Lagrange weights at t = frac(k / R): the formulas
      // of products/od.py::_coarse_upsample (exact but for the final 1/6)
      const float t = static_cast<float>(ks - sg * R) / static_cast<float>(R);
      w[p][0] = -t * (t - 1.0f) * (t - 2.0f) * (1.0f / 6.0f);
      w[p][1] = (t * t - 1.0f) * (t - 2.0f) * 0.5f;
      w[p][2] = -t * (t + 1.0f) * (t - 2.0f) * 0.5f;
      w[p][3] = t * (t * t - 1.0f) * (1.0f / 6.0f);
    }
  }

  float acc[LC][PPT];
  float part[LC][PPT];   // SPLIT: this group's sum, then added to acc
#pragma unroll
  for (int l = 0; l < LC; ++l)
#pragma unroll
    for (int p = 0; p < PPT; ++p) acc[l][p] = 0.0f;

  // the parameter rows of the layers this thread stages
  size_t lay_off[LPW];
#pragma unroll
  for (int t = 0; t < LPW; ++t) {
    const int l = warp + NWARP * t;
    lay_off[t] = l < nl ? static_cast<size_t>(lay_idx[l0 + l]) * n_lines : 0;
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
      if (!CORR) cp_async4(&sm.cap[r][j], wcap + s);
    }
  };
  // raw parameters of chunk ch's (layer, slot) pairs, rows by its lines
  auto issue_params = [&](int ch) {
    const int nc = min(NCH, n_slots - ch * NCH);
    const int r = ch % RING;
#pragma unroll
    for (int t = 0; t < LPW; ++t) {
      const int l = warp + NWARP * t;
      if (l >= nl) continue;
      for (int j = lane; j < nc; j += 32) {
        const int g = sm.line[r][j];
        if (g < 0) continue;
        const size_t off = lay_off[t] + g;
        cp_async4(&sm.raw[0][l][j], shift0 + off);
        cp_async4(&sm.raw[1][l][j], strength + off);
        cp_async4(&sm.raw[2][l][j], gamma_d + off);
        cp_async4(&sm.raw[3][l][j], gamma_0 + off);
        cp_async4(&sm.raw[4][l][j], wing + off);
        if (EXTRA)
          cp_async4(&sm.raw[5][l][j], (MODE == MIX ? ymix : gamma_2) + off);
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
    // constants, windows and the kept pairs of each layer, in slot order
#pragma unroll
    for (int t = 0; t < LPW; ++t) {
      const int l = warp + NWARP * t;
      int n_kept = 0;
#pragma unroll
      for (int q = 0; q < NCH / 32; ++q) {
        const int j = q * 32 + lane;
        bool keep = false;
        LineConst c;
        int2 win;
        int kl = 0;
        float f0 = 0.0f;
        if (l < nl && j < nc && sm.line[r][j] >= 0) {
          kl = sm.k[r][j];
          f0 = sm.f[r][j];
          const float wg = sm.raw[4][l][j];
          const float wv = CORR ? wg : fminf(wg, sm.cap[r][j]);
          c = line_const<MODE>(sm.raw[0][l][j], sm.raw[1][l][j],
                               sm.raw[2][l][j], sm.raw[3][l][j],
                               is_sd(MODE) ? sm.raw[5][l][j] : 1.0f, wv / dx,
                               MODE == MIX ? sm.raw[5][l][j] : 0.0f, dx);
          win = window_range(f0, c.a.z);
          if (MODE == CORE) win = core_range(f0, c, win);
          keep = win.x <= win.y && kl + win.y >= r_lo && kl + win.x <= r_hi;
        }
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          const int pos = n_kept + __popc(bal & ((1u << lane) - 1u));
          sm.c[l][pos] = c;
          sm.meta[l][pos] = make_int4(kl + win.x, kl + win.y, kl,
                                      __float_as_int(f0));
        }
        n_kept += __popc(bal);
      }
      if (lane == 0) sm.n[l] = n_kept;
    }
    __syncthreads();
    if (ch + 1 < n_chunks) issue_params(ch + 1);
    if (ch + 2 < n_chunks) issue_slots(ch + 2);
    cp_async_commit();

    if constexpr (CORR) {
      // the masked node values of every kept (layer, slot), once
      for (int l = 0; l < nl; ++l) {
        const int per_l = sm.n[l] * n_nodes;
        for (int i = tid; i < per_l; i += THREADS) {
          const int j = i / n_nodes;
          const int m = i - j * n_nodes;
          const int kn = t0 + (row0 + m - 1) * R;
          const int4 mt = sm.meta[l][j];
          const float un = static_cast<float>(kn - mt.z) -
                           __int_as_float(mt.w);
          const LineConst c = sm.c[l][j];
          s_nv[(l * NCH + j) * nv_row + m] =
              (un > -c.a.z && un <= c.a.z)
                  ? corr_node<MODE>(un, c, dx, s_wei, n_wei)
                  : 0.0f;
        }
      }
      __syncthreads();
    }
    if (SPLIT && ch * NCH % GROUP == 0) {
#pragma unroll
      for (int l = 0; l < LC; ++l)
#pragma unroll
        for (int p = 0; p < PPT; ++p) part[l][p] = 0.0f;
    }
    if (warp_live) {
#pragma unroll
      for (int l = 0; l < LC; ++l) {
        const int n = sm.n[l];
        for (int i = 0; i < n; ++i) {
          const int4 mt = sm.meta[l][i];
          // warp-uniform: does the window meet this warp's points?
          if (mt.y < wk0 - reach || mt.x > wk0 + WPTS - 1 + reach) continue;
          const LineConst c = sm.c[l][i];
          const float f0 = __int_as_float(mt.w);
#pragma unroll
          for (int p = 0; p < PPT; ++p) {
            const int a = wk0 + p * 32;
            if (!DENSE && (mt.y < a - reach || mt.x > a + 31 + reach))
              continue;
            const float u = static_cast<float>(kg[p] - mt.z) - f0;
            const bool in = u > -c.a.z && u <= c.a.z;
            float& sum = SPLIT ? part[l][p] : acc[l][p];
            if constexpr (CORR) {
              if (!live[p]) continue;
              const float* q = s_nv + (l * NCH + i) * nv_row + seg[p];
              const float interp = q[0] * w[p][0] + q[1] * w[p][1] +
                                   q[2] * w[p][2] + q[3] * w[p][3];
              const float fm =
                  in ? corr_point<MODE>(u, c, dx, s_wei, n_wei) : 0.0f;
              sum += fm - interp;
            } else if constexpr (DENSE) {
              float v;
              if constexpr (MODE == ASYM)
                v = voigt_value<MODE>(u, c, s_wei, n_wei);
              else
                v = ld_value<MODE>(u, c);
              sum = fmaf(c.a.w, in ? v : 0.0f, sum);
            } else if (in) {
              sum += eval<MODE>(u, c, s_wei, n_wei, dx);
            }
          }
        }
      }
    }
    if (SPLIT && ((ch + 1) * NCH % GROUP == 0 || ch + 1 == n_chunks)) {
#pragma unroll
      for (int l = 0; l < LC; ++l)
#pragma unroll
        for (int p = 0; p < PPT; ++p) acc[l][p] += part[l][p];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int l = 0; l < LC; ++l) {
    if (l < nl) {
#pragma unroll
      for (int p = 0; p < PPT; ++p)
        if (live[p])
          out[static_cast<size_t>(l0 + l) * n_out + kg[p]] = acc[l][p];
    }
  }
}

// K7: the unfused kernel (pallas_xsect.py::_make_kernel, launcher
// _xsect_pallas_call, entry xsect_pallas(fused_layers=False)), the kernel of
// the prebuilt-plan route compute_od_layers(engine='pallas', plan=...). It
// computes the same sum as K1 in modes asym, core, full, lorentz and
// doppler, over a shared-block plan (plan_buckets: a tile visits the block
// range [starts[i], starts[i] + counts[i]) of the sorted lines) or a packed
// one, with the wing capped at the plan's bound (wcap: the plan's max_wing,
// or its per-line wing_line). The per-point formula is K1's (line_const and
// eval above), so the two kernels cannot drift apart.
//
// Shape. One CTA per (layer, 256-point slice of a tile), as the Pallas grid
// is (layer, tile, block): 64 threads of 4 points each, the slice's blocks
// walked in order, each block staged CH slots at a time (grid position and
// that layer's constants in shared memory) and summed into registers. Each
// block's sum is kept apart before it joins the total, as the Pallas kernel
// adds one block's sum per grid step, and both sums are compensated
// (Kahan): a shared block holds a tile's strong lines beside hundreds of
// far-wing ones, and in a running float32 sum the far wings' values below
// half an ulp of a narrow Doppler line's peak were lost one by one (7e-6 of
// the peak against the plain version's tree sum over 66 layers of the
// derived list; three FP32 adds per in-window evaluation). Every output is
// written once: no atomics, bit-identical reruns.
//
// Bound. The same evaluations as K1 (the header's hand counts: asym 28,
// core 175 / 14, full 157 / 31 lane-ops inside / outside |x| + y < 15,
// lorentz 18, doppler 20), but a shared-block plan visits whole blocks, so
// most of a tile's slot-points fall outside their window and cost only the
// offset, the two window compares and the branch: chip_smoke.py recounts
// the in-window evaluations on the host and states the bound from them.
// FP32 issue bounds it; per (layer, slot) it reads ~9 scalars, shared by the
// slice's 256 points. A simple kernel: one layer per CTA stages each slot
// once per layer (K1 shares a staged slot's position across 4 layers).
// s + v with the rounding error carried in c (Kahan): s - c is the sum
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
unfused_xsect_kernel(const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ k_line,
                     const float* __restrict__ frac0,
                     const int* __restrict__ line,
                     const float* __restrict__ wcap,
                     const int* __restrict__ lay_idx,
                     const float* __restrict__ shift0,
                     const float* __restrict__ strength,
                     const float* __restrict__ gamma_d,
                     const float* __restrict__ gamma_0,
                     const float* __restrict__ wing, int n_lines,
                     const float* __restrict__ wei_g, int n_wei, int tile,
                     int block, int sub_per_tile, int n_out, float dx,
                     float* __restrict__ out) {
  static_assert(MODE == ASYM || MODE == CORE || MODE == FULL ||
                    MODE == LORENTZ || MODE == DOPPLER,
                "K7 evaluates the Voigt, Lorentz and Doppler modes");
  __shared__ LineConst s_c[1][CH];
  __shared__ int s_k[CH];
  __shared__ float s_f[CH];
  __shared__ float s_wei[MAX_WEI + 1];

  const int tid = threadIdx.x;
  const int tile_i = blockIdx.x / sub_per_tile;
  const int sub = blockIdx.x - tile_i * sub_per_tile;
  const int l = blockIdx.y;
  if (tile_i * tile + sub * SPAN >= n_out) return;
  if (MODE != ASYM) {
    for (int i = tid; i <= n_wei; i += THREADS) s_wei[i] = wei_g[i];
  }

  int kg[PPT];
  bool live[PPT];
  float acc[PPT], acc_c[PPT];   // the total and its Kahan compensation
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int kloc = sub * SPAN + p * THREADS + tid;
    kg[p] = tile_i * tile + kloc;
    live[p] = kloc < tile && kg[p] < n_out;
    acc[p] = 0.0f;
    acc_c[p] = 0.0f;
  }

  const int blk0 = starts[tile_i];
  const int n_blk = counts[tile_i];
  for (int b = 0; b < n_blk; ++b) {
    const int slot0 = (blk0 + b) * block;
    float part[PPT], part_c[PPT];   // this block's sum, compensated
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      part[p] = 0.0f;
      part_c[p] = 0.0f;
    }
    for (int c0 = 0; c0 < block; c0 += CH) {
      const int nc = min(CH, block - c0);
      __syncthreads();   // the previous chunk is consumed
      stage<MODE, CH, true>(c0, nc, slot0, 1, l, tid, k_line, frac0, line,
                            wcap, lay_idx, shift0, strength, gamma_d, gamma_0,
                            wing, nullptr, nullptr, n_lines, dx, s_c, s_k,
                            s_f);
      __syncthreads();
      for (int j = 0; j < nc; ++j) {
        const int kl = s_k[j];
        const float f0 = s_f[j];
        const LineConst c = s_c[0][j];
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
          const float u = static_cast<float>(kg[p] - kl) - f0;
          if (u > -c.a.z && u <= c.a.z)
            kahan_add(part[p], part_c[p], eval<MODE>(u, c, s_wei, n_wei, dx));
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PPT; ++p)
      kahan_add(acc[p], acc_c[p], part[p] - part_c[p]);
  }

#pragma unroll
  for (int p = 0; p < PPT; ++p)
    if (live[p])
      out[static_cast<size_t>(l) * n_out + kg[p]] = acc[p] - acc_c[p];
}

}  // namespace

// K7's entry: mode is K1's code (asym 0, core 1, full 3, lorentz 7,
// doppler 8); lay_idx maps the n_lay output rows to parameter rows.
extern "C" int radtxfr_unfused_xsect(
    int mode, const void* starts, const void* counts, const void* k_line,
    const void* frac0, const void* line, const void* wcap,
    const void* lay_idx, int n_lay, const void* shift0, const void* strength,
    const void* gamma_d, const void* gamma_0, const void* wing, int n_lines,
    const void* wei, int n_wei, int tile, int block, int n_tiles, int n_out,
    double dx, void* out, void* stream) {
  if (n_wei < 1 || n_wei > MAX_WEI || tile < 1 || block < 1 ||
      n_lay > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_per_tile = (tile + SPAN - 1) / SPAN;
  const dim3 grid(static_cast<unsigned>(n_tiles) * sub_per_tile,
                  static_cast<unsigned>(n_lay));
  if (grid.x == 0 || grid.y == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float dxf = static_cast<float>(dx);
#define RADTXFR_LAUNCH_UNFUSED(M)                                            \
  unfused_xsect_kernel<M><<<grid, THREADS, 0, s>>>(                          \
      static_cast<const int*>(starts), static_cast<const int*>(counts),      \
      static_cast<const int*>(k_line), static_cast<const float*>(frac0),     \
      static_cast<const int*>(line), static_cast<const float*>(wcap),        \
      static_cast<const int*>(lay_idx), static_cast<const float*>(shift0),   \
      static_cast<const float*>(strength),                                   \
      static_cast<const float*>(gamma_d), static_cast<const float*>(gamma_0), \
      static_cast<const float*>(wing), n_lines,                              \
      static_cast<const float*>(wei), n_wei, tile, block, sub_per_tile,      \
      n_out, dxf, static_cast<float*>(out))
  switch (mode) {
    case ASYM: RADTXFR_LAUNCH_UNFUSED(ASYM); break;
    case CORE: RADTXFR_LAUNCH_UNFUSED(CORE); break;
    case FULL: RADTXFR_LAUNCH_UNFUSED(FULL); break;
    case LORENTZ: RADTXFR_LAUNCH_UNFUSED(LORENTZ); break;
    case DOPPLER: RADTXFR_LAUNCH_UNFUSED(DOPPLER); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RADTXFR_LAUNCH_UNFUSED
  return static_cast<int>(cudaGetLastError());
}

extern "C" int radtxfr_fused_xsect(
    int mode, int R, const void* starts, const void* counts,
    const void* k_line, const void* frac0, const void* line,
    const void* wcap, const void* lay_idx, int n_lay_call,
    const void* shift0, const void* strength, const void* gamma_d,
    const void* gamma_0, const void* wing, const void* ymix,
    const void* gamma_2, int n_lines, const void* wei, int n_wei, int tile,
    int block, int n_tiles, int max_blocks, int n_out, double dx, void* out,
    void* stream) {
  if (n_wei < 1 || n_wei > MAX_WEI || tile < 1 || block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // a correction slice must start on a node: R divides SPAN and the tile
  if (is_corr(mode) && (R < MIN_R || SPAN % R != 0 || tile % R != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_per_tile = (tile + SPAN - 1) / SPAN;
  const dim3 grid(static_cast<unsigned>(n_tiles) * sub_per_tile,
                  (n_lay_call + LC - 1) / LC);
  if (grid.x == 0 || grid.y == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float dxf = static_cast<float>(dx);
  const bool split =
      static_cast<long long>(max_blocks) * block > SPLIT_SLOTS;
  // the correction passes' node buffer
  const size_t nv_bytes =
      is_corr(mode) ? sizeof(float) * LC * KCH * (SPAN / R + 3) : 0;
#define RADTXFR_LAUNCH_SPLIT(M, SPLIT)                                       \
  fused_xsect_kernel<M, SPLIT><<<grid, THREADS, nv_bytes, s>>>(              \
      static_cast<const int*>(starts), static_cast<const int*>(counts),      \
      static_cast<const int*>(k_line), static_cast<const float*>(frac0),     \
      static_cast<const int*>(line), static_cast<const float*>(wcap),        \
      static_cast<const int*>(lay_idx), n_lay_call,                          \
      static_cast<const float*>(shift0), static_cast<const float*>(strength), \
      static_cast<const float*>(gamma_d), static_cast<const float*>(gamma_0), \
      static_cast<const float*>(wing), static_cast<const float*>(ymix),      \
      static_cast<const float*>(gamma_2), n_lines,                           \
      static_cast<const float*>(wei), n_wei, R, tile, block, sub_per_tile,   \
      n_out, dxf, static_cast<float*>(out))
#define RADTXFR_LAUNCH(M)                                                    \
  if (split) RADTXFR_LAUNCH_SPLIT(M, true);                                  \
  else RADTXFR_LAUNCH_SPLIT(M, false)
  switch (mode) {
    case ASYM: RADTXFR_LAUNCH(ASYM); break;
    case CORE: RADTXFR_LAUNCH(CORE); break;
    case MIX: RADTXFR_LAUNCH(MIX); break;
    case FULL: RADTXFR_LAUNCH(FULL); break;
    case SDV: RADTXFR_LAUNCH(SDV); break;
    case SDV_ASYM: RADTXFR_LAUNCH(SDV_ASYM); break;
    case SDV_CORE: RADTXFR_LAUNCH(SDV_CORE); break;
    case LORENTZ: RADTXFR_LAUNCH(LORENTZ); break;
    case DOPPLER: RADTXFR_LAUNCH(DOPPLER); break;
    // the correction passes always keep per-chunk sums
    case CORR_VOIGT: RADTXFR_LAUNCH_SPLIT(CORR_VOIGT, true); break;
    case CORR_VOIGTFULL: RADTXFR_LAUNCH_SPLIT(CORR_VOIGTFULL, true); break;
    case CORR_SDV: RADTXFR_LAUNCH_SPLIT(CORR_SDV, true); break;
    case CORR_SDVFULL: RADTXFR_LAUNCH_SPLIT(CORR_SDVFULL, true); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RADTXFR_LAUNCH
#undef RADTXFR_LAUNCH_SPLIT
  return static_cast<int>(cudaGetLastError());
}
