// K5 and K6: the layered Hartmann-Tran line-shape accumulation and its
// forward-mode derivative, for Hopper (sm_90a).
//
// K5 replaces radtxfr_tpu/kernels/pallas_xsect.py::_make_fused_ht_kernel
// (launcher _xsect_fused_ht_call, entry xsect_ht_pallas); K6 replaces
// ::_make_fused_ht_jvp_kernel (launcher _xsect_fused_ht_jvp_call, the JVP
// rule of xsect_fused_ht_diff). For each nu-tile i and layer l, K5 computes
//     out[l, i*tile + k] = sum over the tile's packed line slots of
//         mask(u) * strength * pcqsdhc_real(u dx, the 11 line constants),
//     u = (k_grid - k_line) - frac0,  mask: -wingu < u <= wingu,
// wingu = min(wing, the plan's wing cap) / dx, with pcqsdhc_real the real-
// pair form of hapi's pcqsdhc (radtxfr_tpu/kernels/htp_real.py: PART1 with
// its |Z1| > 4e3 branch, PART2, PART3 with its small-|sqrt X| branch, PART4
// with the CPF3 sub-selection, complex eta); K6 computes, per direction d,
// the same sum of the tangent of strength * pcqsdhc_real w.r.t. the strength
// and the 11 constants, a non-finite tangent zeroed (pallas_xsect.py:1127).
// The window is held fixed: the wing's tangent is dropped.
//
// One evaluation, two scalar types. The profile is written once, templated
// on its scalar type: K5 instantiates it with Rn, a float whose operations
// are the non-contracting IEEE intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn) in the order of the plain PyTorch version
// (kernels/htp_real.py::pcqsdhc_real), because the PART4 difference
// w(Z1) - w(Z2) and the final A / (1 - d0 A + e2 B) amplify float32
// rounding (as in K1's SD-Voigt block); K6 instantiates it with Dual<1>, a
// value and the tangent of one direction, so that on the branch each point
// selects it carries the derivative of the same approximation, which is
// what jax.jvp of the Pallas kernel's compute-and-select gives. Comparisons
// and branch choices read the value only. The tangents use torch's forward-
// mode formulas (derivatives.yaml: a*b gives b' a + a' b, a/b gives
// (a' - b' (a/b)) / b, 1/a gives -a' (1/a)^2, sqrt(a) gives a' / (2 sqrt a),
// max(a, floor) passes a' where a >= floor), each operation rounded on its
// own, so that where the real-pair square root's tangent is ill-conditioned
// (Im(X + Y) crossing zero) K6 rounds as the plain version does; division is
// exact (JAX's tangent kernel forces fast=False, pallas_xsect.py:1143-1147).
// K5's FAST instantiation (fused_ht_fast.cu, fast_rcp=True) takes the fast
// reciprocal (k1_skeleton.cuh::rcp_fast) at the w(Z) forms' three
// reciprocals (w_wei's 1/|e|^2 and 1/|e^2|^2, w_asym's 1/|0.5 - z^2|^2),
// where pallas_xsect.py::_voigt_w_KL calls _rcp(., fast); every other
// division of pcqsdhc stays IEEE, as in JAX; that build holds no K6.
// A Dual<N>'s tangent lanes are computed independently by the same
// intrinsics whatever N, so Dual<1> gives each direction the bits its lane
// of a wider dual number would.
//
// The profile is split at the point: ht_pair computes, once per staged
// (slot, row) pair, the values that do not depend on the grid point (PART1's
// test, sqrt(pi) cte, and for Gamma2 or Shift2 live 1/c2t, Y = (1/(2 cte
// c2t))^2, |Y|, csqrtY and sqrt(pi)/(2 csqrtY)); pcqsdhc computes the rest
// at each point. Every value is produced by the same operations in the same
// order as when the whole profile ran at each point, so the split changes
// no bit. Branches. JAX evaluates all four parts (and both hum1_wei forms of
// every w) and selects; here each point branches into the part it selects,
// and every w(Z) into Weideman (|x| + y < 15) or the asymptotic form (or
// CPF3 in PART4's sub-case), so an evaluation pays for the branch it takes.
// PART1 (Gamma2 = Shift2 = 0) is uniform across a pair; PART2/3 never occur
// for physical parameters but are carried, their w(Z) tested per point.
//
// Shape: K1's skeleton over rows, the row skeleton K4 shares
// (k1_skeleton.cuh::row_skeleton, policy HtRows). The output rows are K5's
// layers, or K6's (direction, layer) rows r = d * n_lay_call + l (K3's
// design, fused_xsect_jvp.cu): one CTA per (128-point slice of a tile, 4
// rows), four warps, each owning one 32-point span of the slice and
// staging one row. A K6 row whose direction has no non-zero
// tangent on its layer (the wrapper's (nd, nLay) table `live`) stages
// nothing; a CTA without a live row writes its zeros and stops. The tile's
// slots go through the cp.async ring (slot data two chunks ahead; the row's
// 13 parameters, and in K6 its direction's 12 tangents, one chunk ahead).
// Each staged (slot, row) pair gets its integer window (window_range on the
// capped wing, as the per-point test computes it) and its Weideman range (a
// superset of the grid offsets at which a CPF point of the pair can take
// the Weideman branch, ht_near_range), and is kept, per row in slot order
// (ballot and prefix count), only if the window meets the slice (and, in
// K6, a tangent is non-zero: a pair whose 12 tangents are zero adds exact
// zeros, or non-finite values the guard drops). A kept pair's ht_pair
// values are computed once then. Each warp tests a kept pair's window
// against its span with a warp-uniform compare before any lane evaluates,
// and a span wholly outside the pair's Weideman range runs both CPF points
// (PART1: its one) in the asymptotic form without the per-point region
// test or PART4's CPF3 test: outside both regions |Z| >= 15/sqrt(2) > 8, so
// CPF3 is never taken there. A culled pair or span holds only points whose
// window test fails (or whose terms are exact zeros), and a span sent to
// the asymptotic form holds only points the per-point test sends there, so
// each (row, point) adds the same terms in slot order as a walk over every
// slot: the outputs are the bits of the per-point kernel. Every output is
// written once by one thread: no atomics; the same inputs give
// bit-identical outputs.
//
// Bound. FP32 issue, as K1 and K3: the inner loop reads shared memory only,
// and an evaluation is hundreds of lane-ops. Hand counts from this source
// (a*b+c = 2, sqrt 3, divide 4, a compare or a floor 1, a negation free),
// per evaluation: the window and accumulate 9, the prelude 3; PART4
// through sqrt(X + Y) 37, the rest less its two w(Z) 71 (18 of them |Z1|,
// |Z2| and the CPF3 test, which spans outside the Weideman range skip),
// the final A / (1 - d0 A + e2 B) 31 (151), plus per CPF point the w(Z)
// it takes: the 3-op region test and Weideman with its imaginary part
// (38 + 7 n_wei) or the unguarded asymptotic pair (22); CPF3 175. PART1
// 71 (88 past |Z1| = 4e3) plus one w(Z). Per kept pair (ht_pair): PART4
// 63, PART1 5. K6 adds, per direction, the Dual operators' tangent work as
// written (+ or - 1, dual * dual 3, float * dual 1, dual / dual 6,
// reciprocal 1, square root 4, the floor 0): PART4 202, PART1 107 (132),
// Weideman 65 + 14 n_wei, the asymptotic pair 40, and 5 to accumulate;
// per pair PART4 81, PART1 1; and once per evaluation the reciprocal's
// square and the square root's doubling (PART4 3, Weideman 2, asymptotic
// 1). chip_smoke.py (HT_PIECES) recounts each evaluation's branches on the
// host: a CPF point by its own Weideman region (Z2 = S + c leaves it before
// Z1 = S - c), exactly (the closed-form radius where c2t and csqrtY are
// real, point by point where Shift2 or a complex eta make them complex);
// CPF3's sub-band at Weideman's price; K6's tangent work once per live
// (pair, direction). It also counts the SASS instructions of each piece
// of this file's build (tools/sass.py::ht_eval_instructions) for the
// issue-slot bounds.
//
// Occupancy, chosen by timing: 22.2 KB (K5) and 37.0 KB (K6) of shared
// memory a CTA and no minimum of CTAs an SM: ptxas gives K5 61 registers
// (8 CTAs an SM) and K6 80 (6), without spills. Asking for 4 and 3 CTAs
// (71 and 88 registers) made K5 2-3% slower; register caps for 8 and 6
// CTAs, 64-slot chunks and 8 layers a CTA were slower (PERF.md, PR 8).

#include <cuda_runtime.h>
#include <cfloat>

#include "k1_skeleton.cuh"

namespace {

constexpr int NK = 11;                 // HT constants per (layer, line)
constexpr int NP = 2 + NK;             // strength, wing, constants
constexpr int NT = 1 + NK;             // tangents per direction
constexpr int MAX_WEI = 32;

constexpr float INV_SQRT_PI = static_cast<float>(0.5641895835477563);
constexpr float RPI = static_cast<float>(1.7724538509055159);
constexpr float HALF_RPI = static_cast<float>(0.5 * 1.7724538509055159);
constexpr float TWO_RPI = static_cast<float>(2.0 * 1.7724538509055159);
constexpr float INV_PI = static_cast<float>(0.3183098861837907);



// ---- the two scalar types -------------------------------------------------

// float with non-contracting IEEE operations
struct Rn {
  float v;
  Rn() = default;
  __device__ __forceinline__ Rn(float x) : v(x) {}
};
__device__ __forceinline__ Rn operator+(Rn a, Rn b) { return __fadd_rn(a.v, b.v); }
__device__ __forceinline__ Rn operator-(Rn a, Rn b) { return __fsub_rn(a.v, b.v); }
__device__ __forceinline__ Rn operator*(Rn a, Rn b) { return __fmul_rn(a.v, b.v); }
__device__ __forceinline__ Rn operator/(Rn a, Rn b) { return __fdiv_rn(a.v, b.v); }
__device__ __forceinline__ Rn operator-(Rn a) { return -a.v; }
__device__ __forceinline__ Rn sqrt_(Rn a) { return __fsqrt_rn(a.v); }
__device__ __forceinline__ Rn recip(Rn a) { return __fdiv_rn(1.0f, a.v); }
__device__ __forceinline__ Rn floor_(Rn a, float g) { return a.v >= g ? a : Rn(g); }

// a value and N tangents (forward-mode dual number)
template <int N>
struct Dual {
  float v;
  float t[N];
  Dual() = default;
  __device__ __forceinline__ explicit Dual(float x) : v(x) {
#pragma unroll
    for (int d = 0; d < N; ++d) t[d] = 0.0f;
  }
};
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = __fadd_rn(a.v, b.v);
#pragma unroll
  for (int d = 0; d < N; ++d) r.t[d] = a.t[d] + b.t[d];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = __fadd_rn(a.v, b);
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> r = b;
  r.v = __fadd_rn(a, b.v);
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int d = 0; d < N; ++d) r.t[d] = -a.t[d];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = __fsub_rn(a.v, b.v);
#pragma unroll
  for (int d = 0; d < N; ++d) r.t[d] = a.t[d] - b.t[d];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = __fsub_rn(a.v, b);
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = __fsub_rn(a, b.v);
#pragma unroll
  for (int d = 0; d < N; ++d) r.t[d] = -b.t[d];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = __fmul_rn(a.v, b.v);
#pragma unroll
  for (int d = 0; d < N; ++d)
    r.t[d] = __fadd_rn(__fmul_rn(b.t[d], a.v), __fmul_rn(a.t[d], b.v));
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = __fmul_rn(a, b.v);
#pragma unroll
  for (int d = 0; d < N; ++d) r.t[d] = __fmul_rn(a, b.t[d]);
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  return b * a;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = __fdiv_rn(a.v, b.v);
#pragma unroll
  for (int d = 0; d < N; ++d)
    r.t[d] = __fdiv_rn(__fsub_rn(a.t[d], __fmul_rn(b.t[d], r.v)), b.v);
  return r;
}
// 1 / a, as torch's reciprocal (what Python's 1.0 / tensor calls)
template <int N>
__device__ __forceinline__ Dual<N> recip(const Dual<N>& a) {
  Dual<N> r;
  r.v = __fdiv_rn(1.0f, a.v);
  const float r2 = __fmul_rn(r.v, r.v);
#pragma unroll
  for (int d = 0; d < N; ++d) r.t[d] = __fmul_rn(-a.t[d], r2);
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> sqrt_(const Dual<N>& a) {
  Dual<N> r;
  r.v = __fsqrt_rn(a.v);
  const float h = __fmul_rn(2.0f, r.v);
#pragma unroll
  for (int d = 0; d < N; ++d) r.t[d] = __fdiv_rn(a.t[d], h);
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> floor_(const Dual<N>& a, float g) {
  return a.v >= g ? a : Dual<N>(g);
}

template <class T> __device__ __forceinline__ T cst(float x) { return T(x); }

// 1/a at the reciprocals of the w(Z) forms, where JAX calls _rcp(., fast)
// (_voigt_w_KL): the fast reciprocal in K5's FAST instantiation; K6's dual
// numbers always divide exactly (JAX's tangent kernel forces fast=False)
template <bool FAST>
__device__ __forceinline__ Rn wrecip(Rn a) {
  if constexpr (FAST)
    return rcp_fast(a.v);
  else
    return recip(a);
}
template <bool FAST, int N>
__device__ __forceinline__ Dual<N> wrecip(const Dual<N>& a) {
  static_assert(!FAST, "K6 has no fast reciprocal");
  return recip(a);
}

// ---- real-pair complex helpers (kernels/htp_real.py) ------------------------

template <class T>
struct Cx {
  T r, i;
};

template <class T>
__device__ __forceinline__ Cx<T> cmul(const Cx<T>& a, const Cx<T>& b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}

template <class T>
__device__ __forceinline__ Cx<T> cinv(const Cx<T>& a) {
  const T m = floor_(a.r * a.r + a.i * a.i, FLT_MIN);
  return {a.r / m, (-a.i) / m};
}

// principal square root, Im taking the sign of Im a by >= 0
template <class T>
__device__ __forceinline__ Cx<T> csqrt(const Cx<T>& a) {
  const T r = sqrt_(floor_(a.r * a.r + a.i * a.i, FLT_MIN));
  const T u = sqrt_(floor_(0.5f * (r + a.r), FLT_MIN));
  const T vm = sqrt_(floor_(0.5f * (r - a.r), FLT_MIN));
  return {u, a.i.v >= 0.0f ? vm : -vm};
}

// (Re w, Im w) of the Weideman series, |x| + y < 15
// (fused_xsect.py::_voigt_w_KL)
template <bool FAST, class T>
__device__ __forceinline__ Cx<T> w_wei(const T& x, const T& y,
                                       const float* wei, int n_wei) {
  const float L = wei[0];
  const T nr = L - y, ni = x;
  const T er = L + y, ei = -x;
  const T inv_e = wrecip<FAST>(er * er + ei * ei);
  const T zr = (nr * er + ni * ei) * inv_e;
  const T zi = (ni * er - nr * ei) * inv_e;
  T pr = cst<T>(wei[1]), pi = cst<T>(0.0f);
  for (int k = 2; k <= n_wei; ++k) {
    const T t = (pr * zr - pi * zi) + wei[k];
    pi = pr * zi + pi * zr;
    pr = t;
  }
  const T sr = er * er - ei * ei;
  const T si = (2.0f * er) * ei;
  const T inv_s = wrecip<FAST>(sr * sr + si * si);
  return {(2.0f * (pr * sr + pi * si)) * inv_s + (INV_SQRT_PI * er) * inv_e,
          (2.0f * (pi * sr - pr * si)) * inv_s - (INV_SQRT_PI * ei) * inv_e};
}

// (Re w, Im w) of the unguarded asymptotic form, outside |x| + y < 15
template <bool FAST, class T>
__device__ __forceinline__ Cx<T> w_asym(const T& x, const T& y) {
  const T dr = (0.5f + y * y) - x * x;
  const T di = (-2.0f * x) * y;
  const T inv = INV_SQRT_PI * wrecip<FAST>(dr * dr + di * di);
  return {(y * dr - x * di) * inv, (-(x * dr + y * di)) * inv};
}

// (Re w, Im w) by hum1_wei's region rule; `far` (uniform across the warp):
// the caller knows the point lies outside |x| + y < 15
template <bool FAST, class T>
__device__ __forceinline__ Cx<T> voigt_w(const T& x, const T& y,
                                         const float* wei, int n_wei,
                                         bool far) {
  if (!far && __fadd_rn(fabsf(x.v), y.v) < REGION_BOUND)
    return w_wei<FAST>(x, y, wei, n_wei);
  return w_asym<FAST>(x, y);
}

// hapi's 15-term asymptotic CPF (fused_xsect.py::_cpf3_pair), |z|^2 >= 9
template <class T>
__device__ __forceinline__ Cx<T> cpf3(const T& x, const T& y) {
  const T m = floor_(x * x + y * y, 9.0f);
  const T ar = x / m;
  const T ai = (-y) / m;
  const T m2r = ar * ar - ai * ai;
  const T m2i = (2.0f * ar) * ai;
  T sr = cst<T>(1.0f), si = cst<T>(0.0f), tr = cst<T>(1.0f), ti = cst<T>(0.0f);
#pragma unroll 1
  for (int k = 0; k < 15; ++k) {
    const float tt = 0.5f + static_cast<float>(k);
    const T ntr = (tr * m2r - ti * m2i) * tt;
    ti = (tr * m2i + ti * m2r) * tt;
    tr = ntr;
    sr = sr + tr;
    si = si + ti;
  }
  return {(-(ar * si + ai * sr)) * INV_SQRT_PI, (ar * sr - ai * si) * INV_SQRT_PI};
}

// hapi's CPF convention: w at (x, y) = (-Im Z, Re Z)
template <bool FAST, class T>
__device__ __forceinline__ Cx<T> w_of(const Cx<T>& z, const float* wei,
                                      int n_wei, bool far) {
  return voigt_w<FAST>(-z.i, z.r, wei, n_wei, far);
}

// |z| on the values only (it decides branches)
template <class T>
__device__ __forceinline__ float mag(const Cx<T>& z) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(z.r.v, z.r.v), __fmul_rn(z.i.v, z.i.v)));
}

// ---- the profile: per pair, then per point -----------------------------------

// The point-independent values of pcqsdhc for one (layer, line) from its
// constants k[0..10] (HT_CONST_KEYS order: cte, c0t, c2t, csqrtY, d0, e2 as
// pairs). PART1 pairs use cte, rc, k1, k2, d0 and e2 only.
template <class T>
struct HtPair {
  T cte, rc, k1, k2;
  Cx<T> ic2, Y, cy, hc, d0, e2;
  float absY, thr2;   // |Y| and 3e-8 |Y| (PART2's test)
  int part1;
};

// PART2-4's point-independent values
template <class T>
__device__ __forceinline__ void ht_pair234(HtPair<T>& h, const Cx<T>& c2t,
                                           const T* k) {
  h.ic2 = cinv(c2t);
  const T c2x = 2.0f * k[0];
  const Cx<T> y0 = cinv(Cx<T>{c2x * c2t.r, c2x * c2t.i});
  h.Y = cmul(y0, y0);
  h.absY = mag(h.Y);
  h.thr2 = __fmul_rn(3.0e-8f, h.absY);
  const bool cy0 = __fadd_rn(__fmul_rn(k[5].v, k[5].v),
                             __fmul_rn(k[6].v, k[6].v)) == 0.0f;
  h.cy = cy0 ? Cx<T>{cst<T>(1.0f), cst<T>(0.0f)} : Cx<T>{k[5], k[6]};
  const Cx<T> icy = cinv(h.cy);
  h.hc = {HALF_RPI * icy.r, HALF_RPI * icy.i};
}

template <class T>
__device__ __forceinline__ HtPair<T> ht_pair(const T* k) {
  HtPair<T> h;
  h.cte = k[0];
  h.rc = RPI * k[0];
  h.k1 = k[1];
  h.k2 = k[2];
  h.d0 = {k[7], k[8]};
  h.e2 = {k[9], k[10]};
  const Cx<T> c2t = {k[3], k[4]};
  h.part1 = __fadd_rn(__fmul_rn(c2t.r.v, c2t.r.v),
                      __fmul_rn(c2t.i.v, c2t.i.v)) == 0.0f;
  if (!h.part1) {
    ht_pair234(h, c2t, k);
  } else {
    const Cx<T> zero = {cst<T>(0.0f), cst<T>(0.0f)};
    h.ic2 = h.Y = h.cy = h.hc = zero;
    h.absY = h.thr2 = 0.0f;
  }
  return h;
}

// PART1's B, |Z1| > 4e3
template <class T>
__device__ __forceinline__ Cx<T> ht_b1_big(const Cx<T>& z1, const Cx<T>& w1,
                                           const HtPair<T>& h) {
  const Cx<T> i1 = cinv(z1);
  const Cx<T> i3 = cmul(i1, cmul(i1, i1));
  return {h.cte * ((RPI * w1.r + 0.5f * i1.r) - 0.75f * i3.r),
          h.cte * ((RPI * w1.i + 0.5f * i1.i) - 0.75f * i3.i)};
}

// PART1's B, |Z1| <= 4e3
template <class T>
__device__ __forceinline__ Cx<T> ht_b1_small(const Cx<T>& z1,
                                             const Cx<T>& w1,
                                             const HtPair<T>& h) {
  const Cx<T> z2 = cmul(z1, z1);
  const Cx<T> bw = cmul(Cx<T>{1.0f - z2.r, -z2.i}, w1);
  return {h.rc * (bw.r + z1.r * INV_SQRT_PI), h.rc * (bw.i + z1.i * INV_SQRT_PI)};
}

// PART1 (Gamma2 = Shift2 = 0)
template <bool FAST, class T>
__device__ __forceinline__ void ht_part1(const Cx<T>& z1, const HtPair<T>& h,
                                         const float* wei, int n_wei,
                                         bool far, Cx<T>& A, Cx<T>& B) {
  const Cx<T> w1 = w_of<FAST>(z1, wei, n_wei, far);
  A = {h.rc * w1.r, h.rc * w1.i};
  B = mag(z1) > 4.0e3f ? ht_b1_big(z1, w1, h) : ht_b1_small(z1, w1, h);
}

// PART4, with the CPF3-vs-CPF sub-selection (none where `far`)
template <bool FAST, class T>
__device__ __forceinline__ void ht_part4(const Cx<T>& sxy, const HtPair<T>& h,
                                         const float* wei, int n_wei,
                                         bool far, Cx<T>& A, Cx<T>& B) {
  const Cx<T>& cy = h.cy;
  const Cx<T> Z1 = {sxy.r - cy.r, sxy.i - cy.i};
  const Cx<T> Z2 = {Z1.r + 2.0f * cy.r, Z1.i + 2.0f * cy.i};
  bool use3 = false;
  if (!far) {
    const float sz1 = mag(Z1), sz2 = mag(Z2);
    use3 = fabsf(__fsub_rn(sz1, sz2)) <= 1.0f && fmaxf(sz1, sz2) > 8.0f &&
           fminf(sz1, sz2) <= 8.0f;
  }
  const Cx<T> w14 =
      use3 ? cpf3(-Z1.i, Z1.r) : w_of<FAST>(Z1, wei, n_wei, far);
  const Cx<T> w24 =
      use3 ? cpf3(-Z2.i, Z2.r) : w_of<FAST>(Z2, wei, n_wei, far);
  A = {h.rc * (w14.r - w24.r), h.rc * (w14.i - w24.i)};
  const Cx<T> s1 = cmul(Z1, Z1), s2 = cmul(Z2, Z2);
  const Cx<T> t1 = cmul(Cx<T>{1.0f - s1.r, -s1.i}, w14);
  const Cx<T> t2 = cmul(Cx<T>{1.0f - s2.r, -s2.i}, w24);
  const Cx<T> hh = cmul(h.hc, Cx<T>{t1.r - t2.r, t1.i - t2.i});
  B = cmul(Cx<T>{hh.r - 1.0f, hh.i}, h.ic2);
}

// PART2's and PART3's A and B (returned from their out-of-line functions)
template <class T>
struct AB {
  Cx<T> A, B;
};

// PART2 (|X| tiny against |Y|): never for physical parameters, so out of
// line (its operands by value: no local copies on the common path)
template <bool FAST, class T>
__device__ __noinline__ AB<T> ht_part2(Cx<T> z1, Cx<T> sxy,
                                       const HtPair<T>& h, const float* wei,
                                       int n_wei) {
  const Cx<T> z2b = {sxy.r + h.cy.r, sxy.i + h.cy.i};
  const Cx<T> w12 = w_of<FAST>(z1, wei, n_wei, false);
  const Cx<T> w22 = w_of<FAST>(z2b, wei, n_wei, false);
  AB<T> o;
  o.A = {h.rc * (w12.r - w22.r), h.rc * (w12.i - w22.i)};
  const Cx<T> s1 = cmul(z1, z1), s2 = cmul(z2b, z2b);
  const Cx<T> u1 = cmul(Cx<T>{1.0f - s1.r, -s1.i}, w12);
  const Cx<T> u2 = cmul(Cx<T>{1.0f - s2.r, -s2.i}, w22);
  const Cx<T> h2 = cmul(h.hc, Cx<T>{u1.r - u2.r, u1.i - u2.i});
  o.B = cmul(Cx<T>{h2.r - 1.0f, h2.i}, h.ic2);
  return o;
}

// PART3 (|Y| tiny against |X|): never for physical parameters, out of line
template <bool FAST, class T>
__device__ __noinline__ AB<T> ht_part3(Cx<T> X, Cx<T> sxy,
                                       const HtPair<T>& h, const float* wei,
                                       int n_wei) {
  const Cx<T>& Y = h.Y;
  const Cx<T>& ic2 = h.ic2;
  const Cx<T> wxy = w_of<FAST>(sxy, wei, n_wei, false);
  const Cx<T> sX = csqrt(X);
  const Cx<T> cc = {(1.0f - X.r) - 2.0f * Y.r, (-X.i) - 2.0f * Y.i};
  const Cx<T> sw = cmul(sxy, wxy);
  AB<T> o;
  if (mag(sX) <= 4.0e3f) {
    const Cx<T> wx = w_of<FAST>(sX, wei, n_wei, false);
    const Cx<T> sxwx = cmul(sX, wx);
    const Cx<T> g = {INV_SQRT_PI - sxwx.r, -sxwx.i};
    o.A = cmul(Cx<T>{TWO_RPI * g.r, TWO_RPI * g.i}, ic2);
    const Cx<T> cg = cmul(cc, g);
    o.B = cmul(Cx<T>{(-1.0f + TWO_RPI * cg.r) + TWO_RPI * sw.r,
                     TWO_RPI * cg.i + TWO_RPI * sw.i},
               ic2);
  } else {
    const Cx<T> iX = cinv(X);
    const Cx<T> iX2 = cmul(iX, iX);
    const Cx<T> hx = {iX.r - 1.5f * iX2.r, iX.i - 1.5f * iX2.i};
    o.A = cmul(hx, ic2);
    const Cx<T> chx = cmul(cc, hx);
    o.B = cmul(Cx<T>{(-1.0f + chx.r) + TWO_RPI * sw.r, chx.i + TWO_RPI * sw.i},
               ic2);
  }
  return o;
}

// PART2-4 (Gamma2 or Shift2 live): X, sqrt(X + Y) and the part's A, B
template <bool FAST, class T>
__device__ __forceinline__ void ht_part234(const Cx<T>& t0, const Cx<T>& z1,
                                           const HtPair<T>& h,
                                           const float* wei, int n_wei,
                                           bool far, Cx<T>& A, Cx<T>& B) {
  const Cx<T> X = cmul(t0, h.ic2);
  const float absX = mag(X);
  const bool part2 = absX <= h.thr2;
  const bool part3 = !part2 && h.absY <= __fmul_rn(1.0e-15f, absX);
  const Cx<T> sxy = csqrt(Cx<T>{X.r + h.Y.r, X.i + h.Y.i});
  if (part2 || part3) {
    const AB<T> o = part2 ? ht_part2<FAST>(z1, sxy, h, wei, n_wei)
                          : ht_part3<FAST>(X, sxy, h, wei, n_wei);
    A = o.A;
    B = o.B;
  } else {
    ht_part4<FAST>(sxy, h, wei, n_wei, far, A, B);
  }
}

// LS = (1/pi) A / (1 - d0 A + e2 B)
template <class T>
__device__ __forceinline__ T ht_ls(const Cx<T>& A, const Cx<T>& B,
                                   const HtPair<T>& h) {
  const Cx<T> dA = cmul(h.d0, A);
  const Cx<T> eB = cmul(h.e2, B);
  const Cx<T> inv = cinv(Cx<T>{(1.0f - dA.r) + eB.r, (-dA.i) + eB.i});
  return (A.r * inv.r - A.i * inv.i) * INV_PI;
}

// Re LS of pcqsdhc at dnu for the pair h: the operations of
// kernels/htp_real.py::pcqsdhc_real on the part the point selects
template <bool FAST, class T>
__device__ __forceinline__ T pcqsdhc(float dnu, const HtPair<T>& h,
                                     const float* wei, int n_wei, bool far) {
  const Cx<T> t0 = {h.k1, (-dnu) + h.k2};     // i(sg0 - sg) + c0t
  const Cx<T> z1 = {t0.r * h.cte, t0.i * h.cte};
  Cx<T> A, B;
  if (h.part1)
    ht_part1<FAST>(z1, h, wei, n_wei, far, A, B);
  else
    ht_part234<FAST>(t0, z1, h, wei, n_wei, far, A, B);
  return ht_ls(A, B, h);
}

// ---- staging ------------------------------------------------------------------

// The grid offsets d - k_line (a superset, within the window range win) at
// which a CPF point of a pair with constants k (values) can take hum1_wei's
// Weideman branch; all of win where that is not known in closed form. PART1:
// |x| + y < 15 with x = (dnu - k2) cte, y = k1 cte, so |dnu - k2| < (15 -
// y) / cte. PART4 with c2t and csqrtY = c real: Z = S -+ c, S = sqrt(X + Y)
// = us + i vs, P = Re(X + Y) (computed as the point loop computes it) and
// |Im(X + Y)| = |k2 - dnu| / |c2t|; Z lies in |Im Z| + Re Z < 15 where
// us + |vs| < R = 15 +- c, and (us + |vs|)^2 = |X + Y| + |Im(X + Y)| grows
// with |Im(X + Y)| from |P|: below R^2 exactly where |Im(X + Y)| < (R^4 -
// P^2) / (2 R^2), nowhere if |P| >= R^2 (chip_smoke.py::cpf_radius; the
// wider R = 15 + |c| bounds both points). Each radius is widened by 1e-4 of
// itself and a grid step (window_range adds two more), as core_range's.
__device__ __forceinline__ int2 ht_near_range(float f0, const float* k,
                                              float dx, int2 win) {
  const float cte = k[0], k1 = k[1], k2 = k[2], c2r = k[3], c2i = k[4];
  const float cyr = k[5], cyi = k[6];
  float r;
  if (__fadd_rn(__fmul_rn(c2r, c2r), __fmul_rn(c2i, c2i)) == 0.0f) {
    const float y = __fmul_rn(k1, cte);      // as the point loop rounds it
    if (!(y < REGION_BOUND)) return make_int2(1, 0);
    r = __fsub_rn(REGION_BOUND, y) / (dx * cte);
  } else if (c2i == 0.0f && cyi == 0.0f &&
             __fmul_rn(cyr, cyr) != 0.0f) {
    // Re(X + Y) = k1 Re(1/c2t) + Re(y0)^2, y0 = 1/(2 cte c2t), as ht_pair
    // and ht_part234 round it
    const float ic2r = __fdiv_rn(c2r, fmaxf(__fmul_rn(c2r, c2r), FLT_MIN));
    const float c2 = __fmul_rn(__fmul_rn(2.0f, cte), c2r);
    const float y0r = __fdiv_rn(c2, fmaxf(__fmul_rn(c2, c2), FLT_MIN));
    const float P = fabsf(__fadd_rn(__fmul_rn(k1, ic2r), __fmul_rn(y0r, y0r)));
    const float R = REGION_BOUND + fabsf(cyr);
    const float R2 = R * R;
    if (!(P < R2 * 1.001f)) return make_int2(1, 0);
    r = fmaxf((R2 - P) * (R2 + P), 0.0f) / (2.0f * R2) / (fabsf(ic2r) * dx);
  } else {
    return win;
  }
  const int2 cw = window_range(f0 + k2 / dx, r * 1.0001f + 1.0f);
  return make_int2(max(win.x, cw.x), min(win.y, cw.y));
}

// the (nLay, L) parameter rows (strength, wing, the 11 constants) and, for
// K6, the (n_dir, nLay, L) tangent rows (strength, the 11 constants)
struct HtPtrs {
  const float* p[NP];
  const float* t[NT];
};

template <bool TAN> struct Scalar { using type = Rn; };
template <> struct Scalar<true> { using type = Dual<1>; };

// K5: strength * LS added to the running sum
__device__ __forceinline__ float accumulate(float sum, const Rn& s,
                                            const Rn& ls) {
  return sum + __fmul_rn(s.v, ls.v);
}
// K6: d(strength * LS) = strength_t LS + strength LS_t, non-finite dropped
__device__ __forceinline__ float accumulate(float sum, const Dual<1>& s,
                                            const Dual<1>& ls) {
  const float v = __fadd_rn(__fmul_rn(s.t[0], ls.v), __fmul_rn(s.v, ls.t[0]));
  return isfinite(v) ? sum + v : sum;
}

// K5's (TAN false) and K6's policy of the row skeleton
// (k1_skeleton.cuh::row_skeleton): K5's rows are the layers of the call
// (n_dir 1, no live table), K6's (direction, layer) rows; FAST: the fast
// reciprocal in the w(Z) forms (K5 only)
template <bool TAN, bool FAST>
struct HtRows {
  using T = typename Scalar<TAN>::type;
  static constexpr int N_PRM = NP, N_TAN = TAN ? NT : 0, I_WING = 1;
  static constexpr int MAX_WEI = ::MAX_WEI;
  using Ptrs = HtPtrs;
  struct Kept {
    HtPair<T> pair[ROW_LC][ROW_CH];
    T s[ROW_LC][ROW_CH];
    float wingu[ROW_LC][ROW_CH];
  };

  static __device__ __forceinline__ int2 stage(
      Kept& kept, const float (*raw)[ROW_LC][ROW_CH], int i, int j, int pos,
      float f0, float wu, int2 win, float dx) {
    float kv[NK];
#pragma unroll
    for (int e = 0; e < NK; ++e) kv[e] = raw[2 + e][i][j];
    const int2 nrg = ht_near_range(f0, kv, dx, win);
    T kk[NK];
    T sv = cst<T>(raw[0][i][j]);
#pragma unroll
    for (int e = 0; e < NK; ++e) kk[e] = cst<T>(kv[e]);
    if constexpr (TAN) {
#pragma unroll
      for (int e = 0; e < NK; ++e) kk[e].t[0] = raw[NP + 1 + e][i][j];
      sv.t[0] = raw[NP][i][j];
    }
    kept.pair[i][pos] = ht_pair<T>(kk);
    kept.s[i][pos] = sv;
    kept.wingu[i][pos] = wu;
    return nrg;
  }

  static __device__ __forceinline__ float eval(float sum, const Kept& kept,
                                               int i, int k, float u,
                                               bool pt_live, bool far,
                                               const float* wei, int n_wei,
                                               float dx) {
    const float wu = kept.wingu[i][k];
    if (!pt_live || !(u > -wu && u <= wu)) return sum;
    const T ls = pcqsdhc<FAST>(__fmul_rn(u, dx), kept.pair[i][k], wei,
                               n_wei, far);
    return accumulate(sum, kept.s[i][k], ls);
  }
};

template <bool TAN, bool FAST>
__global__ void __launch_bounds__(ROW_THREADS)
fused_ht_kernel(const RowArgs<HtPtrs> args) {
  __shared__ RowSmem<HtRows<TAN, FAST>> sm;
  __shared__ float s_wei[MAX_WEI + 1];
  row_skeleton<HtRows<TAN, FAST>>(args, sm, s_wei);
}

// K5 (TAN false, this build's FAST) or K6 (TAN true, IEEE only)
template <bool TAN, bool FAST>
int launch(const void* starts, const void* counts, const void* k_line,
           const void* frac0, const void* line, const void* wcap,
           const void* tile_off, const void* lay_idx, int n_lay_call,
           const void* live, const HtPtrs& ptr, int n_dir, int n_lay,
           int n_lines, const void* wei, int n_wei, int tile, int block,
           int n_tiles, int n_out, double dx, void* out, void* stream) {
  return row_launch<HtRows<TAN, FAST>>(
      fused_ht_kernel<TAN, FAST>, starts, counts, k_line, frac0, line, wcap,
      tile_off, lay_idx, n_lay_call, live, ptr, n_dir, n_lay, n_lines, wei,
      n_wei, tile, block, n_tiles, n_out, dx, out, stream);
}

}  // namespace

// K5's entry: the (nLay, L) rows strength, wing and the 11 constants
// (HT_CONST_KEYS order); out (n_lay_call, n_out)
extern "C" int RADTXFR_ENTRY(radtxfr_fused_ht)(
    const void* starts, const void* counts, const void* k_line,
    const void* frac0, const void* line, const void* wcap,
    const void* tile_off, const void* lay_idx, int n_lay_call, const void* strength,
    const void* wing, const void* c0, const void* c1, const void* c2,
    const void* c3, const void* c4, const void* c5, const void* c6,
    const void* c7, const void* c8, const void* c9, const void* c10,
    int n_lay, int n_lines, const void* wei, int n_wei, int tile, int block,
    int n_tiles, int n_out, double dx, void* out, void* stream) {
  const HtPtrs ptr = {
      {static_cast<const float*>(strength), static_cast<const float*>(wing),
       static_cast<const float*>(c0), static_cast<const float*>(c1),
       static_cast<const float*>(c2), static_cast<const float*>(c3),
       static_cast<const float*>(c4), static_cast<const float*>(c5),
       static_cast<const float*>(c6), static_cast<const float*>(c7),
       static_cast<const float*>(c8), static_cast<const float*>(c9),
       static_cast<const float*>(c10)},
      {}};
  return launch<false, BUILD_FAST>(
      starts, counts, k_line, frac0, line, wcap, tile_off, lay_idx,
      n_lay_call, nullptr, ptr, 1, n_lay, n_lines, wei, n_wei, tile, block,
      n_tiles, n_out, dx, out, stream);
}

#if !RADTXFR_FAST

// K6's entry: live is the launch's (n_dir, n_lay) int32 table of the
// directions' non-zero tangents per parameter layer; the parameter rows as
// K5's, then the (n_dir, nLay, L) tangents of the strength and the 11
// constants; out (n_dir, n_lay_call, n_out)
extern "C" int radtxfr_fused_ht_jvp(
    const void* starts, const void* counts, const void* k_line,
    const void* frac0, const void* line, const void* wcap,
    const void* tile_off, const void* lay_idx, int n_lay_call, const void* live,
    const void* strength, const void* wing, const void* c0, const void* c1,
    const void* c2, const void* c3, const void* c4, const void* c5,
    const void* c6, const void* c7, const void* c8, const void* c9,
    const void* c10, const void* strength_t, const void* t0, const void* t1,
    const void* t2, const void* t3, const void* t4, const void* t5,
    const void* t6, const void* t7, const void* t8, const void* t9,
    const void* t10, int n_dir, int n_lay, int n_lines, const void* wei,
    int n_wei, int tile, int block, int n_tiles, int n_out, double dx,
    void* out, void* stream) {
  const HtPtrs ptr = {
      {static_cast<const float*>(strength), static_cast<const float*>(wing),
       static_cast<const float*>(c0), static_cast<const float*>(c1),
       static_cast<const float*>(c2), static_cast<const float*>(c3),
       static_cast<const float*>(c4), static_cast<const float*>(c5),
       static_cast<const float*>(c6), static_cast<const float*>(c7),
       static_cast<const float*>(c8), static_cast<const float*>(c9),
       static_cast<const float*>(c10)},
      {static_cast<const float*>(strength_t), static_cast<const float*>(t0),
       static_cast<const float*>(t1), static_cast<const float*>(t2),
       static_cast<const float*>(t3), static_cast<const float*>(t4),
       static_cast<const float*>(t5), static_cast<const float*>(t6),
       static_cast<const float*>(t7), static_cast<const float*>(t8),
       static_cast<const float*>(t9), static_cast<const float*>(t10)}};
  return launch<true, false>(starts, counts, k_line, frac0, line, wcap,
                             tile_off, lay_idx, n_lay_call, live, ptr, n_dir,
                             n_lay, n_lines, wei, n_wei, tile, block, n_tiles,
                             n_out, dx, out, stream);
}
#endif  // !RADTXFR_FAST
