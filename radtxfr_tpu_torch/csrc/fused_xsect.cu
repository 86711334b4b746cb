// K1: bucketed layered line-shape accumulation for Hopper (sm_90a).
//
// Replaces radtxfr_tpu/kernels/pallas_xsect.py::_make_fused_kernel (launcher
// _xsect_fused_call, entry xsect_pallas(fused_layers=True)) in the modes the
// production OD path runs: asym (guarded Humlicek asymptotic Re w), core
// (Weideman - guarded asym inside |x| + y < 15) and mix (unguarded K/L blend
// scaled by K + Y L); and in the mode the differentiable (Jacobian) OD path
// runs as its primal: full (the single-pass hum1_wei blend, Weideman inside
// |x| + y < 15 and the UNGUARDED asymptotic form outside,
// pallas_xsect.py::_voigt_wr). For each nu-tile i and layer l it computes
//     out[l, i*tile + k] = sum over the tile's packed line slots of
//                          mask(u) * f_mode(u),
//     u = (k_grid - k_line) - frac0   (int32 difference, then float),
// with hapi's window mask -wingu < u <= wingu.
//
// Shape. One CTA per (256-point slice of a tile, chunk of LC layers); one
// thread per PPT points of the slice (strided by THREADS so a warp covers
// 32 consecutive points: coalesced stores, near-uniform window masks). The
// CTA walks its tile's blocks [starts[i], starts[i] + counts[i]) in chunks
// of CH slots: it stages each slot's grid position and, per layer, the
// eight per-(line, layer) constants the evaluation needs (two float4: one
// 16-byte shared-memory broadcast each) and accumulates in registers. Every
// output is written once by one thread, in a fixed order: no atomics, and
// the same inputs give bit-identical outputs.
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
// in the core. Each evaluation reads two float4 from shared memory
// (amortised over the PPT points of a thread) and nothing from device
// memory; the staged constants cost ~6 scattered global loads per (slot,
// layer), shared by the 256 points of the slice. So every mode is bound by
// FP32 issue (and, for asym, by the IEEE reciprocal's multi-instruction
// sequence), not by bytes: registers hold the LC x PPT accumulators and the
// inner loop touches no device memory. The branch on the window mask (and,
// in core, mix and full, on the region) skips evaluations whose
// contribution the Pallas kernel computes and then discards; chip_smoke.py
// recounts the in-window and in-core evaluations of each pass on the host
// and states the bound from them: per production member 2.69 ms for asym
// (6.4e9 evaluations, a third of the plan's 2.1e10 slot-points), 0.12 ms
// core and 0.11 ms mix, and 3.06 ms for the Jacobian's full primal (H100
// 80GB HBM3 at 700 W, against 12.4, 2.3, 0.7 and 19.3 ms measured).
//
// Numerics follow the Pallas kernel op for op, in float32: dx*cte, g0*cte
// and strength*(1/sqrt(pi)*cte) per (line, layer); IEEE division for every
// reciprocal (the TPU path's approximate reciprocal plus Newton step is not
// carried over; do not build with --use_fast_math). nvcc contracts a*b+c
// into FMA, a float-rounding-level difference from XLA.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;            // threads per CTA
constexpr int PPT = 4;                 // grid points per thread
constexpr int SPAN = THREADS * PPT;    // points per CTA
constexpr int LC = 4;                  // layers per CTA
constexpr int CH = 64;                 // line slots staged per step
constexpr int MAX_WEI = 32;            // Weideman terms at most

constexpr float SQRT_LN2 = static_cast<float>(0.8325546111576977);
constexpr float INV_SQRT_PI = static_cast<float>(0.5641895835477563);
constexpr float REGION_BOUND = 15.0f;
constexpr float GUARD = 0.25f;

enum Mode { ASYM = 0, CORE = 1, MIX = 2, FULL = 3 };

// a = (ds, xs, wingu, scale), b = (y, 0.5 + y*y, -2*y, Y_mix)
struct LineConst {
  float4 a;
  float4 b;
};

__device__ __forceinline__ LineConst line_const(float shift0, float strength,
                                                float gd, float g0,
                                                float wingu, float ymix,
                                                float dx) {
  const float cte = SQRT_LN2 / gd;
  const float y = g0 * cte;
  LineConst c;
  c.a = make_float4(shift0 / dx, dx * cte, wingu,
                    strength * (INV_SQRT_PI * cte));
  c.b = make_float4(y, 0.5f + y * y, -2.0f * y, ymix);
  return c;
}

// Humlicek region-1 asymptotic Re w with the denominator clamp
// (pallas_xsect.py::_asym_re_w, guard = 0.25).
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

template <int MODE>
__device__ __forceinline__ float eval(float u, const LineConst& c,
                                      const float* wei, int n_wei) {
  const float x = (u - c.a.x) * c.a.y;
  const float y = c.b.x;
  if (MODE == ASYM) return c.a.w * asym_re_w(x, c.b);
  const bool in_core = fabsf(x) + y < REGION_BOUND;
  if (MODE == CORE) {
    if (!in_core) return 0.0f;
    float re, im;
    weideman_w<false>(x, y, wei, n_wei, &re, &im);
    return c.a.w * (re - asym_re_w(x, c.b));
  }
  if (MODE == FULL) {
    float re, im;
    if (in_core) {
      weideman_w<false>(x, y, wei, n_wei, &re, &im);
    } else {
      // unguarded asymptotic Re w (pallas_xsect.py::_voigt_wr, mode 'full')
      const float dr = c.b.y - x * x;
      const float di = c.b.z * x;
      re = INV_SQRT_PI * (y * dr - x * di) * (1.0f / (dr * dr + di * di));
    }
    return c.a.w * re;
  }
  float K, Lw;
  if (in_core) {
    weideman_w<true>(x, y, wei, n_wei, &K, &Lw);
  } else {
    // unguarded asymptotic K and L (pallas_xsect.py::_voigt_w_KL)
    const float dr = c.b.y - x * x;
    const float di = c.b.z * x;
    const float inv = INV_SQRT_PI * (1.0f / (dr * dr + di * di));
    K = (y * dr - x * di) * inv;
    Lw = -(x * dr + y * di) * inv;
  }
  return c.a.w * (K + c.b.w * Lw);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
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
                   const float* __restrict__ ymix, int n_lines,
                   const float* __restrict__ wei_g, int n_wei, int tile,
                   int block, int sub_per_tile, int n_out, float dx,
                   float* __restrict__ out) {
  __shared__ LineConst s_c[LC][CH];
  __shared__ int s_k[CH];
  __shared__ float s_f[CH];
  __shared__ float s_wei[MAX_WEI + 1];

  const int tid = threadIdx.x;
  const int tile_i = blockIdx.x / sub_per_tile;
  const int sub = blockIdx.x - tile_i * sub_per_tile;
  const int l0 = blockIdx.y * LC;
  const int nl = min(LC, n_lay_call - l0);

  if (MODE != ASYM) {
    for (int i = tid; i <= n_wei; i += THREADS) s_wei[i] = wei_g[i];
  }

  int kg[PPT];
  bool live[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int kloc = sub * SPAN + p * THREADS + tid;
    kg[p] = tile_i * tile + kloc;
    live[p] = kloc < tile && kg[p] < n_out;
  }

  float acc[LC][PPT];
#pragma unroll
  for (int l = 0; l < LC; ++l)
#pragma unroll
    for (int p = 0; p < PPT; ++p) acc[l][p] = 0.0f;

  const int slot0 = starts[tile_i] * block;
  const int n_slots = counts[tile_i] * block;
  for (int c0 = 0; c0 < n_slots; c0 += CH) {
    const int nc = min(CH, n_slots - c0);
    __syncthreads();   // the previous chunk is consumed
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
        s_c[l][j] = line_const(shift0[off], strength[off], gamma_d[off],
                               gamma_0[off], fminf(wing[off], wcap[s]) / dx,
                               MODE == MIX ? ymix[off] : 0.0f, dx);
      } else {
        // padding slot, filled as the Pallas wrapper pads (never in-window)
        s_c[l][j] = line_const(0.0f, 0.0f, 1.0f, 1.0f, 0.0f,
                               MODE == MIX ? 1.0f : 0.0f, dx);
      }
    }
    __syncthreads();
    for (int j = 0; j < nc; ++j) {
      const int kl = s_k[j];
      const float f0 = s_f[j];
      float u[PPT];
#pragma unroll
      for (int p = 0; p < PPT; ++p) u[p] = static_cast<float>(kg[p] - kl) - f0;
#pragma unroll
      for (int l = 0; l < LC; ++l) {
        if (l < nl) {
          const LineConst c = s_c[l][j];
#pragma unroll
          for (int p = 0; p < PPT; ++p) {
            if (u[p] > -c.a.z && u[p] <= c.a.z)
              acc[l][p] += eval<MODE>(u[p], c, s_wei, n_wei);
          }
        }
      }
    }
  }

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

}  // namespace

extern "C" int radtxfr_fused_xsect(
    int mode, const void* starts, const void* counts, const void* k_line,
    const void* frac0, const void* line, const void* wcap,
    const void* lay_idx, int n_lay_call, const void* shift0,
    const void* strength, const void* gamma_d, const void* gamma_0,
    const void* wing, const void* ymix, int n_lines, const void* wei,
    int n_wei, int tile, int block, int n_tiles, int n_out, double dx,
    void* out, void* stream) {
  if (n_wei < 1 || n_wei > MAX_WEI || tile < 1 || block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub_per_tile = (tile + SPAN - 1) / SPAN;
  const dim3 grid(static_cast<unsigned>(n_tiles) * sub_per_tile,
                  (n_lay_call + LC - 1) / LC);
  if (grid.x == 0 || grid.y == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RADTXFR_LAUNCH(M)                                                    \
  fused_xsect_kernel<M><<<grid, THREADS, 0, s>>>(                            \
      static_cast<const int*>(starts), static_cast<const int*>(counts),      \
      static_cast<const int*>(k_line), static_cast<const float*>(frac0),     \
      static_cast<const int*>(line), static_cast<const float*>(wcap),        \
      static_cast<const int*>(lay_idx), n_lay_call,                          \
      static_cast<const float*>(shift0), static_cast<const float*>(strength), \
      static_cast<const float*>(gamma_d), static_cast<const float*>(gamma_0), \
      static_cast<const float*>(wing), static_cast<const float*>(ymix),      \
      n_lines, static_cast<const float*>(wei), n_wei, tile, block,           \
      sub_per_tile, n_out, static_cast<float>(dx), static_cast<float*>(out))
  switch (mode) {
    case ASYM: RADTXFR_LAUNCH(ASYM); break;
    case CORE: RADTXFR_LAUNCH(CORE); break;
    case MIX: RADTXFR_LAUNCH(MIX); break;
    case FULL: RADTXFR_LAUNCH(FULL); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RADTXFR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
