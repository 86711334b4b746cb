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
// One evaluation, two scalar types. The profile is written once
// (pcqsdhc<T>), templated on its scalar type: K5 instantiates it with Rn, a
// float whose operations are the non-contracting IEEE intrinsics
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn) in the order of the plain
// PyTorch version (kernels/htp_real.py::pcqsdhc_real), because the PART4
// difference w(Z1) - w(Z2) and the final A / (1 - d0 A + e2 B) amplify
// float32 rounding (as in K1's SD-Voigt block); K6 instantiates it with
// Dual<ND>, a value and ND tangents, so that on the branch each point
// selects it carries the derivative of the same approximation, which is
// what jax.jvp of the Pallas kernel's compute-and-select gives. Comparisons
// and branch choices read the value only. The tangents use torch's forward-
// mode formulas (derivatives.yaml: a*b gives b' a + a' b, a/b gives
// (a' - b' (a/b)) / b, 1/a gives -a' (1/a)^2, sqrt(a) gives a' / (2 sqrt a),
// max(a, floor) passes a' where a >= floor), each operation rounded on its
// own, so that where the real-pair square root's tangent is ill-conditioned
// (Im(X + Y) crossing zero) K6 rounds as the plain version does; division is
// exact (JAX's tangent kernel forces fast=False, pallas_xsect.py:1143-1147).
//
// Branches. JAX evaluates all four parts (and both hum1_wei forms of every
// w) and selects; here each point branches into the part it selects, and
// every w(Z) into Weideman (|x| + y < 15) or the asymptotic form (or CPF3
// in PART4's sub-case), so an evaluation pays for the branch it takes.
// PART1 (Gamma2 = Shift2 = 0) is uniform across a slot; PART2/3 never occur
// for physical parameters but are carried.
//
// Shape. One CTA per (SPAN-point slice of a tile, LC layers), one thread
// per point: SPAN = 128, the tile of the JAX HT builders (od.py:1219), so a
// CTA covers a whole plan tile and no thread idles. The CTA walks its
// tile's slots in chunks of CH, stages each (layer, slot)'s strength, wingu
// and 11 constants (and, in K6, its 12 x ND tangents) in shared memory,
// accumulates in registers and writes each output once: no atomics, the
// same inputs give bit-identical outputs. K6 skips a (layer, slot) whose
// tangents are all zero (its contribution is exactly zero after the
// non-finite guard) and a CTA none of whose layers has a tangent (lay_live).
//
// Bound. FP32 issue, as K1 and K3: the inner loop reads shared memory only,
// and an evaluation is hundreds of lane-ops. Hand counts from this source
// (a*b+c = 2, sqrt 3, divide 4, a negation free), per evaluation: the
// window and accumulate 9, the prelude 8; PART4 the shared part through
// 1/csqrtY 95, PART4 less its two w(Z) 71, the final A / (1 - d0 A + e2 B)
// 31 (214), plus per CPF point the w(Z) it takes: the 3-op region test and
// Weideman with its imaginary part (38 + 7 n_wei) or the unguarded
// asymptotic pair (22); CPF3 175. PART1 76 (93 past |Z1| = 4e3) plus one
// w(Z). K6 adds, per direction, the Dual operators' tangent work as written
// (+ or - 1, dual * dual 3, float * dual 1, dual / dual 6, reciprocal 1,
// square root 4): PART4 283, PART1 108 (133), Weideman 65 + 14 n_wei, the
// asymptotic pair 40, and 5 to accumulate; and once per evaluation the
// reciprocal's square and the square root's doubling (PART4 3, Weideman 2,
// asymptotic 1). chip_smoke.py (HT_PIECES) recounts each evaluation's
// branches on the host: a CPF point by its own Weideman region (Z2 = S + c
// leaves it before Z1 = S - c), exactly (the closed-form radius where c2t and
// csqrtY are real, point by point where Shift2 or a complex eta make them
// complex); CPF3's sub-band at Weideman's price. JAX computes all four parts
// and every form of every w, about 1300 + 42 n_wei lane-ops per evaluation;
// this kernel branches instead, and K6 evaluates the profile once per
// (slot, point) for all ND directions. Registers: pcqsdhc keeps ~40
// complex temporaries live; ptxas's report (chip_smoke.py phase 2) decides
// the ND the wrapper launches (fused_ht.py HT_JVP_DIRS).

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int THREADS = 128;           // threads per CTA, one point each
constexpr int SPAN = THREADS;          // points per CTA
constexpr int LC = 4;                  // layers per CTA (K5)
constexpr int CH = 32;                 // line slots staged per step (K5)
constexpr int LC_T = 2;                // ... K6
constexpr int CH_T = 16;
constexpr int NK = 11;                 // HT constants per (layer, line)
constexpr int NP = 2 + NK;             // strength, wing, constants
constexpr int NT = 1 + NK;             // tangents per direction
constexpr int ND_MAX = 4;              // directions per K6 launch at most
constexpr int MAX_WEI = 32;

constexpr float INV_SQRT_PI = static_cast<float>(0.5641895835477563);
constexpr float RPI = static_cast<float>(1.7724538509055159);
constexpr float HALF_RPI = static_cast<float>(0.5 * 1.7724538509055159);
constexpr float TWO_RPI = static_cast<float>(2.0 * 1.7724538509055159);
constexpr float INV_PI = static_cast<float>(0.3183098861837907);
constexpr float REGION_BOUND = 15.0f;

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

// (Re w, Im w) by hum1_wei's region rule (fused_xsect.py::_voigt_w_KL)
template <class T>
__device__ __forceinline__ Cx<T> voigt_w(const T& x, const T& y,
                                         const float* wei, int n_wei) {
  if (__fadd_rn(fabsf(x.v), y.v) < REGION_BOUND) {
    const float L = wei[0];
    const T nr = L - y, ni = x;
    const T er = L + y, ei = -x;
    const T inv_e = recip(er * er + ei * ei);
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
    const T inv_s = recip(sr * sr + si * si);
    return {(2.0f * (pr * sr + pi * si)) * inv_s + (INV_SQRT_PI * er) * inv_e,
            (2.0f * (pi * sr - pr * si)) * inv_s - (INV_SQRT_PI * ei) * inv_e};
  }
  const T dr = (0.5f + y * y) - x * x;
  const T di = (-2.0f * x) * y;
  const T inv = INV_SQRT_PI * recip(dr * dr + di * di);
  return {(y * dr - x * di) * inv, (-(x * dr + y * di)) * inv};
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
template <class T>
__device__ __forceinline__ Cx<T> w_of(const Cx<T>& z, const float* wei,
                                      int n_wei) {
  return voigt_w(-z.i, z.r, wei, n_wei);
}

// |z| on the values only (it decides branches)
template <class T>
__device__ __forceinline__ float mag(const Cx<T>& z) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(z.r.v, z.r.v), __fmul_rn(z.i.v, z.i.v)));
}

// Re LS of pcqsdhc at dnu from the constants k[0..10] (HT_CONST_KEYS order:
// cte, c0t, c2t, csqrtY, d0, e2 as pairs); the operations of
// kernels/htp_real.py::pcqsdhc_real on the part the point selects
template <class T>
__device__ T pcqsdhc(float dnu, const T* k, const float* wei, int n_wei) {
  const T& cte = k[0];
  const Cx<T> t0 = {k[1], (-dnu) + k[2]};     // i(sg0 - sg) + c0t
  const Cx<T> c2t = {k[3], k[4]};
  const T rc = RPI * cte;
  const Cx<T> z1 = {t0.r * cte, t0.i * cte};
  Cx<T> A, B;
  if (__fadd_rn(__fmul_rn(c2t.r.v, c2t.r.v), __fmul_rn(c2t.i.v, c2t.i.v)) ==
      0.0f) {
    // PART1
    const Cx<T> w1 = w_of(z1, wei, n_wei);
    A = {rc * w1.r, rc * w1.i};
    if (mag(z1) > 4.0e3f) {
      const Cx<T> i1 = cinv(z1);
      const Cx<T> i3 = cmul(i1, cmul(i1, i1));
      B = {cte * ((RPI * w1.r + 0.5f * i1.r) - 0.75f * i3.r),
           cte * ((RPI * w1.i + 0.5f * i1.i) - 0.75f * i3.i)};
    } else {
      const Cx<T> z2 = cmul(z1, z1);
      const Cx<T> bw = cmul(Cx<T>{1.0f - z2.r, -z2.i}, w1);
      B = {rc * (bw.r + z1.r * INV_SQRT_PI), rc * (bw.i + z1.i * INV_SQRT_PI)};
    }
  } else {
    const Cx<T> ic2 = cinv(c2t);
    const Cx<T> X = cmul(t0, ic2);
    const T c2x = 2.0f * cte;
    const Cx<T> y0 = cinv(Cx<T>{c2x * c2t.r, c2x * c2t.i});
    const Cx<T> Y = cmul(y0, y0);
    const float absX = mag(X), absY = mag(Y);
    const bool part2 = absX <= __fmul_rn(3.0e-8f, absY);
    const bool part3 = !part2 && absY <= __fmul_rn(1.0e-15f, absX);
    const Cx<T> sxy = csqrt(Cx<T>{X.r + Y.r, X.i + Y.i});
    const bool cy0 = __fadd_rn(__fmul_rn(k[5].v, k[5].v),
                               __fmul_rn(k[6].v, k[6].v)) == 0.0f;
    const Cx<T> cy = cy0 ? Cx<T>{cst<T>(1.0f), cst<T>(0.0f)} : Cx<T>{k[5], k[6]};
    const Cx<T> icy = cinv(cy);
    const Cx<T> hc = {HALF_RPI * icy.r, HALF_RPI * icy.i};
    if (part2) {
      const Cx<T> z2b = {sxy.r + cy.r, sxy.i + cy.i};
      const Cx<T> w12 = w_of(z1, wei, n_wei);
      const Cx<T> w22 = w_of(z2b, wei, n_wei);
      A = {rc * (w12.r - w22.r), rc * (w12.i - w22.i)};
      const Cx<T> s1 = cmul(z1, z1), s2 = cmul(z2b, z2b);
      const Cx<T> u1 = cmul(Cx<T>{1.0f - s1.r, -s1.i}, w12);
      const Cx<T> u2 = cmul(Cx<T>{1.0f - s2.r, -s2.i}, w22);
      const Cx<T> h2 = cmul(hc, Cx<T>{u1.r - u2.r, u1.i - u2.i});
      B = cmul(Cx<T>{h2.r - 1.0f, h2.i}, ic2);
    } else if (part3) {
      const Cx<T> wxy = w_of(sxy, wei, n_wei);
      const Cx<T> sX = csqrt(X);
      const Cx<T> cc = {(1.0f - X.r) - 2.0f * Y.r, (-X.i) - 2.0f * Y.i};
      const Cx<T> sw = cmul(sxy, wxy);
      if (mag(sX) <= 4.0e3f) {
        const Cx<T> wx = w_of(sX, wei, n_wei);
        const Cx<T> sxwx = cmul(sX, wx);
        const Cx<T> g = {INV_SQRT_PI - sxwx.r, -sxwx.i};
        A = cmul(Cx<T>{TWO_RPI * g.r, TWO_RPI * g.i}, ic2);
        const Cx<T> cg = cmul(cc, g);
        B = cmul(Cx<T>{(-1.0f + TWO_RPI * cg.r) + TWO_RPI * sw.r,
                       TWO_RPI * cg.i + TWO_RPI * sw.i},
                 ic2);
      } else {
        const Cx<T> iX = cinv(X);
        const Cx<T> iX2 = cmul(iX, iX);
        const Cx<T> hx = {iX.r - 1.5f * iX2.r, iX.i - 1.5f * iX2.i};
        A = cmul(hx, ic2);
        const Cx<T> chx = cmul(cc, hx);
        B = cmul(Cx<T>{(-1.0f + chx.r) + TWO_RPI * sw.r,
                       chx.i + TWO_RPI * sw.i},
                 ic2);
      }
    } else {
      // PART4, with the CPF3-vs-CPF sub-selection
      const Cx<T> Z1 = {sxy.r - cy.r, sxy.i - cy.i};
      const Cx<T> Z2 = {Z1.r + 2.0f * cy.r, Z1.i + 2.0f * cy.i};
      const float sz1 = mag(Z1), sz2 = mag(Z2);
      const bool use3 = fabsf(__fsub_rn(sz1, sz2)) <= 1.0f &&
                        fmaxf(sz1, sz2) > 8.0f && fminf(sz1, sz2) <= 8.0f;
      const Cx<T> w14 = use3 ? cpf3(-Z1.i, Z1.r) : w_of(Z1, wei, n_wei);
      const Cx<T> w24 = use3 ? cpf3(-Z2.i, Z2.r) : w_of(Z2, wei, n_wei);
      A = {rc * (w14.r - w24.r), rc * (w14.i - w24.i)};
      const Cx<T> s1 = cmul(Z1, Z1), s2 = cmul(Z2, Z2);
      const Cx<T> t1 = cmul(Cx<T>{1.0f - s1.r, -s1.i}, w14);
      const Cx<T> t2 = cmul(Cx<T>{1.0f - s2.r, -s2.i}, w24);
      const Cx<T> h = cmul(hc, Cx<T>{t1.r - t2.r, t1.i - t2.i});
      B = cmul(Cx<T>{h.r - 1.0f, h.i}, ic2);
    }
  }
  // LS = (1/pi) A / (1 - d0 A + e2 B)
  const Cx<T> dA = cmul(Cx<T>{k[7], k[8]}, A);
  const Cx<T> eB = cmul(Cx<T>{k[9], k[10]}, B);
  const Cx<T> inv = cinv(Cx<T>{(1.0f - dA.r) + eB.r, (-dA.i) + eB.i});
  return (A.r * inv.r - A.i * inv.i) * INV_PI;
}

// ---- the kernels ------------------------------------------------------------

struct Tile {
  int tile_i, l0, nl, kg;
  bool live;
};

__device__ __forceinline__ Tile tile_of(int tile, int sub_per_tile,
                                        int n_lay_call, int n_out, int lc) {
  Tile t;
  t.tile_i = blockIdx.x / sub_per_tile;
  const int sub = blockIdx.x - t.tile_i * sub_per_tile;
  t.l0 = blockIdx.y * lc;
  t.nl = min(lc, n_lay_call - t.l0);
  const int kloc = sub * SPAN + threadIdx.x;
  t.kg = t.tile_i * tile + kloc;
  t.live = kloc < tile && t.kg < n_out;
  return t;
}

// K5: one CTA per (SPAN-point slice of a tile, LC layers)
__global__ void __launch_bounds__(THREADS)
fused_ht_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                const int* __restrict__ k_line, const float* __restrict__ frac0,
                const int* __restrict__ line, const float* __restrict__ wcap,
                const int* __restrict__ lay_idx, int n_lay_call,
                const float* __restrict__ prm, int n_lay, int n_lines,
                const float* __restrict__ wei_g, int n_wei, int tile,
                int block, int sub_per_tile, int n_out, float dx,
                float* __restrict__ out) {
  __shared__ float s_p[LC][CH][NP];
  __shared__ int s_k[CH];
  __shared__ float s_f[CH];
  __shared__ float s_wei[MAX_WEI + 1];
  const int tid = threadIdx.x;
  const Tile t = tile_of(tile, sub_per_tile, n_lay_call, n_out, LC);
  for (int i = tid; i <= n_wei; i += THREADS) s_wei[i] = wei_g[i];
  const size_t plane = static_cast<size_t>(n_lay) * n_lines;

  float acc[LC];
#pragma unroll
  for (int l = 0; l < LC; ++l) acc[l] = 0.0f;

  const int slot0 = starts[t.tile_i] * block;
  const int n_slots = counts[t.tile_i] * block;
  for (int c0 = 0; c0 < n_slots; c0 += CH) {
    const int nc = min(CH, n_slots - c0);
    __syncthreads();   // the previous chunk is consumed
    for (int j = tid; j < nc; j += THREADS) {
      s_k[j] = k_line[slot0 + c0 + j];
      s_f[j] = frac0[slot0 + c0 + j];
    }
    for (int i = tid; i < t.nl * nc; i += THREADS) {
      const int l = i / nc;
      const int j = i - l * nc;
      const int s = slot0 + c0 + j;
      const int g = line[s];
      float* p = s_p[l][j];
      if (g >= 0) {
        const size_t off = static_cast<size_t>(lay_idx[t.l0 + l]) * n_lines + g;
        p[0] = prm[off];
        p[1] = fminf(prm[plane + off], wcap[s]) / dx;
#pragma unroll
        for (int q = 0; q < NK; ++q) p[2 + q] = prm[(2 + q) * plane + off];
      } else {
        p[1] = 0.0f;   // padding: never in the window
      }
    }
    __syncthreads();
    if (!t.live) continue;
    for (int j = 0; j < nc; ++j) {
      const float u = static_cast<float>(t.kg - s_k[j]) - s_f[j];
      const float dnu = __fmul_rn(u, dx);
#pragma unroll
      for (int l = 0; l < LC; ++l) {
        if (l >= t.nl) break;
        const float* p = s_p[l][j];
        if (!(u > -p[1] && u <= p[1])) continue;
        Rn k[NK];
#pragma unroll
        for (int q = 0; q < NK; ++q) k[q] = p[2 + q];
        acc[l] += __fmul_rn(p[0], pcqsdhc<Rn>(dnu, k, s_wei, n_wei).v);
      }
    }
  }
  if (!t.live) return;
#pragma unroll
  for (int l = 0; l < LC; ++l)
    if (l < t.nl) out[static_cast<size_t>(t.l0 + l) * n_out + t.kg] = acc[l];
}

// K6: the tangents of ND directions; tan is (n_dir, NT, nLay, L)
template <int ND>
__global__ void __launch_bounds__(THREADS)
fused_ht_jvp_kernel(const int* __restrict__ starts,
                    const int* __restrict__ counts,
                    const int* __restrict__ k_line,
                    const float* __restrict__ frac0,
                    const int* __restrict__ line,
                    const float* __restrict__ wcap,
                    const int* __restrict__ lay_idx, int n_lay_call,
                    const int* __restrict__ lay_live,
                    const float* __restrict__ prm,
                    const float* __restrict__ tan, int n_dir, int n_lay,
                    int n_lines, const float* __restrict__ wei_g, int n_wei,
                    int tile, int block, int sub_per_tile, int n_out, float dx,
                    float* __restrict__ out) {
  __shared__ float s_p[LC_T][CH_T][NP];
  __shared__ float s_t[LC_T][CH_T][ND][NT];
  __shared__ int s_pl[LC_T][CH_T];
  __shared__ int s_k[CH_T];
  __shared__ float s_f[CH_T];
  __shared__ float s_wei[MAX_WEI + 1];
  __shared__ int s_live[LC_T];
  const int tid = threadIdx.x;
  const Tile t = tile_of(tile, sub_per_tile, n_lay_call, n_out, LC_T);
  for (int i = tid; i <= n_wei; i += THREADS) s_wei[i] = wei_g[i];
  if (tid < LC_T) s_live[tid] = tid < t.nl ? lay_live[lay_idx[t.l0 + tid]] : 0;
  const size_t plane = static_cast<size_t>(n_lay) * n_lines;

  float acc[LC_T][ND];
#pragma unroll
  for (int l = 0; l < LC_T; ++l)
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[l][d] = 0.0f;

  __syncthreads();
  bool any_live = false;
#pragma unroll
  for (int l = 0; l < LC_T; ++l) any_live |= s_live[l] != 0;
  const int slot0 = starts[t.tile_i] * block;
  const int n_slots = any_live ? counts[t.tile_i] * block : 0;
  for (int c0 = 0; c0 < n_slots; c0 += CH_T) {
    const int nc = min(CH_T, n_slots - c0);
    __syncthreads();
    for (int j = tid; j < nc; j += THREADS) {
      s_k[j] = k_line[slot0 + c0 + j];
      s_f[j] = frac0[slot0 + c0 + j];
    }
    for (int i = tid; i < t.nl * nc; i += THREADS) {
      const int l = i / nc;
      const int j = i - l * nc;
      const int s = slot0 + c0 + j;
      const int g = line[s];
      bool pair_live = false;
      if (g >= 0 && s_live[l]) {
        const size_t off = static_cast<size_t>(lay_idx[t.l0 + l]) * n_lines + g;
        float* p = s_p[l][j];
        p[0] = prm[off];
        p[1] = fminf(prm[plane + off], wcap[s]) / dx;
#pragma unroll
        for (int q = 0; q < NK; ++q) p[2 + q] = prm[(2 + q) * plane + off];
#pragma unroll
        for (int d = 0; d < ND; ++d) {
#pragma unroll
          for (int q = 0; q < NT; ++q) {
            const float v = d < n_dir
                                ? tan[(static_cast<size_t>(d) * NT + q) * plane + off]
                                : 0.0f;
            s_t[l][j][d][q] = v;
            pair_live |= v != 0.0f;
          }
        }
      }
      s_pl[l][j] = pair_live;
    }
    __syncthreads();
    if (!t.live) continue;
    for (int j = 0; j < nc; ++j) {
      const float u = static_cast<float>(t.kg - s_k[j]) - s_f[j];
      const float dnu = __fmul_rn(u, dx);
#pragma unroll
      for (int l = 0; l < LC_T; ++l) {
        if (l >= t.nl) break;
        if (!s_pl[l][j]) continue;   // uniform across the CTA
        const float* p = s_p[l][j];
        if (!(u > -p[1] && u <= p[1])) continue;
        Dual<ND> k[NK];
#pragma unroll
        for (int q = 0; q < NK; ++q) {
          k[q].v = p[2 + q];
#pragma unroll
          for (int d = 0; d < ND; ++d) k[q].t[d] = s_t[l][j][d][1 + q];
        }
        const Dual<ND> ls = pcqsdhc<Dual<ND>>(dnu, k, s_wei, n_wei);
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          // d(strength * ls) = strength_t ls + strength ls_t
          const float v = __fadd_rn(__fmul_rn(s_t[l][j][d][0], ls.v),
                                    __fmul_rn(p[0], ls.t[d]));
          if (isfinite(v)) acc[l][d] += v;
        }
      }
    }
  }
  if (!t.live) return;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (d >= n_dir) break;
#pragma unroll
    for (int l = 0; l < LC_T; ++l)
      if (l < t.nl)
        out[(static_cast<size_t>(d) * n_lay_call + t.l0 + l) * n_out + t.kg] =
            acc[l][d];
  }
}

}  // namespace

extern "C" int radtxfr_fused_ht(
    const void* starts, const void* counts, const void* k_line,
    const void* frac0, const void* line, const void* wcap,
    const void* lay_idx, int n_lay_call, const void* prm, int n_lay,
    int n_lines, const void* wei, int n_wei, int tile, int block,
    int n_tiles, int n_out, double dx, void* out, void* stream) {
  if (n_wei < 1 || n_wei > MAX_WEI || tile < 1 || block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_per_tile = (tile + SPAN - 1) / SPAN;
  const dim3 grid(static_cast<unsigned>(n_tiles) * sub_per_tile,
                  (n_lay_call + LC - 1) / LC);
  if (grid.x == 0 || grid.y == 0) return 0;
  fused_ht_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const int*>(k_line), static_cast<const float*>(frac0),
      static_cast<const int*>(line), static_cast<const float*>(wcap),
      static_cast<const int*>(lay_idx), n_lay_call,
      static_cast<const float*>(prm), n_lay, n_lines,
      static_cast<const float*>(wei), n_wei, tile, block, sub_per_tile, n_out,
      static_cast<float>(dx), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int radtxfr_fused_ht_jvp(
    const void* starts, const void* counts, const void* k_line,
    const void* frac0, const void* line, const void* wcap,
    const void* lay_idx, int n_lay_call, const void* lay_live,
    const void* prm, const void* tan, int n_dir, int n_lay, int n_lines,
    const void* wei, int n_wei, int tile, int block, int n_tiles, int n_out,
    double dx, void* out, void* stream) {
  if (n_wei < 1 || n_wei > MAX_WEI || tile < 1 || block < 1 || n_dir < 1 ||
      n_dir > ND_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_per_tile = (tile + SPAN - 1) / SPAN;
  const dim3 grid(static_cast<unsigned>(n_tiles) * sub_per_tile,
                  (n_lay_call + LC_T - 1) / LC_T);
  if (grid.x == 0 || grid.y == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RADTXFR_LAUNCH(ND)                                                   \
  fused_ht_jvp_kernel<ND><<<grid, THREADS, 0, s>>>(                          \
      static_cast<const int*>(starts), static_cast<const int*>(counts),      \
      static_cast<const int*>(k_line), static_cast<const float*>(frac0),     \
      static_cast<const int*>(line), static_cast<const float*>(wcap),        \
      static_cast<const int*>(lay_idx), n_lay_call,                          \
      static_cast<const int*>(lay_live), static_cast<const float*>(prm),     \
      static_cast<const float*>(tan), n_dir, n_lay, n_lines,                 \
      static_cast<const float*>(wei), n_wei, tile, block, sub_per_tile,      \
      n_out, static_cast<float>(dx), static_cast<float*>(out))
  if (n_dir == 1) {
    RADTXFR_LAUNCH(1);
  } else if (n_dir == 2) {
    RADTXFR_LAUNCH(2);
  } else {
    RADTXFR_LAUNCH(4);
  }
#undef RADTXFR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
