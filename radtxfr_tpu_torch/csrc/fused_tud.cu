// K2: fused transmittance / upwelling / downwelling composition (sm_90a).
//
// Replaces radtxfr_tpu/kernels/pallas_tud.py::_build_kernel (launcher
// tud_compose_pallas, wrapper products/tud.py::make_tud_pallas_fn) in both
// of its modes. For each wavenumber column nu = 100 x:
//   * the source of every layer: PLANCK computes B_l = c1 1e4 nu^3 /
//     expm1(c2 nu / T_l) (units of core/planck.py::planckian,
//     µW/(cm^2 sr cm^-1)); otherwise B (nL, nX) is an input (planck=False);
//   * the up pass, once per slant secant m, ground to top:
//     Lu <- t Lu + (1 - t) B_l, t = exp(-m od_l), cum += od_l, snapshotting
//     tau = exp(-m cum) (or the path OD m cum) and Lu at each sensor
//     altitude's layer count; altitudes below the ground layer give tau = 1
//     (path OD 0) and Lu = 0;
//   * the down pass over the quadrature angles, top to ground:
//     Ld_a <- t_a Ld_a + (1 - t_a) B_l, then Ld = sum_a w_a Ld_a.
//
// Shape. One thread per column, TPB columns per CTA. The CTA first puts
// each layer's sensor altitudes into a 64-bit mask (one shared load a layer
// tells the up pass whether it snapshots). The first up sweep computes each
// column's B_l a layer ahead of its use (one expm1 and one IEEE divide per
// column and layer, independent of the carry chain it overlaps, or one
// coalesced read of the input B) and keeps it in shared memory, where the
// later sweeps and the down pass read it; both passes prefetch the next
// layer's od one layer ahead,
// keep every carry in registers and write the carries as
// Lu <- B + t (Lu - B) (one FADD and one FFMA). tau and Lu are staged in
// shared memory and leave the CTA as one contiguous run of (TPB, nZs, nMu)
// floats; Ld is one coalesced store. The downwelling secants of an angle
// chunk are held as exponent factors c_a = -sec_a log2(e) (a masked angle
// has c_a = 0: t = 1, its carry stays 0 and it is not summed), so that
// t_a = 2^(od c_a). Every output is written once: no atomics,
// bit-identical reruns.
//
// Bound. Per column and layer the down pass evaluates nA exponentials and
// the up pass nMu, each in one carry step (carry_step: an FMUL, the MUFU
// and the carry's FADD and FFMA). At the production shape (66 layers,
// 1,440,001 columns, 30 angles, 1 secant) those are 2.9e9 exp2: each costs
// the special-function unit 8 of its SM sub-partition's issue cycles (16
// results per clock per SM) against 4 issue slots for the step, so the
// exp2 on the special-function units alone would bound it (0.70 ms at 1.98
// GHz). The bytes (od read twice, once from L2 at best, B once in that
// mode, the outputs once: 0.4-0.5 GB) take 0.15 ms. The Planck source
// costs one expm1 and one divide per column and layer, once.
//
// Planck uses expm1f: the Pallas kernel uses exp - 1 only because Mosaic has
// no expm1 lowering (pallas_tud.py:40-43).
//
// The tangent mode (fused_tud_kernel_jvp: PLANCK, transmittance; no TPU
// counterpart, JAX differentiates its scan composition). For nD directions
// it takes the layer-OD tangents dod (nD, nL, nX) and the temperature
// tangents dT (nD, nL) and writes the tangents dtau, dLu (nD, nX, nZs,
// nMu) and dLd (nD, nX); the primal is K2's (PLANCK), launched apart.
// The source's tangent dB = dB/dT dT with dB/dT = B (c2 nu / T) / T (1 + 1
// / expm1(c2 nu / T)), dB/dT computed once a column and layer and shared
// by every direction. Three sweeps a column, one thread a column:
//   * A, ground to top: the exclusive prefix sums cum_l = sum_{k<l} od_k
//     (the up pass's own order) into shared memory, and the total; the
//     loads of LCH_A layers issued together;
//   * B, top to ground: Ld's sensitivities. With T_a(l) = 2^(c_a cum_l)
//     the angle's transmittance from the ground to layer l's bottom, Ld =
//     sum_a w_a sum_l (T_a(l) - T_a(l+1)) B_l, and
//       S_B[l]  = d Ld / d B_l  = sum_a w_a (T_a(l) - T_a(l+1)),
//       S_od[l] = d Ld / d od_l = sum_a w_a sec_a (T_a(l+1) B_l - V_a(l)),
//     V_a(l) = sum_{j>l} (T_a(j) - T_a(j+1)) B_j carried top down: one
//     exp2 a column, layer and angle (the primal's count), no carry per
//     direction, angles in chunks of TACH held in registers (one chunk at
//     30 angles, whose S_B then takes the prefix OD's place);
//   * C, ground to top, directions in chunks of DCH: the up pass with its
//     forward-mode tangent, dLu <- t dLu + dt (Lu - B) + (1 - t) dB with
//     dt = -m t dod (t = 2^(od c) once a layer and secant, shared by the
//     chunk), dcum += dod, dtau = -m dcum tau at each snapshot, and
//     dLd = sum_l S_od[l] dod_l + S_B[l] dB_l. dod is read
//     once, coalesced, in groups of LCH_C layers loaded a group ahead;
//     every carry lives in registers, Lu's and tau's as K2 steps them.
// Every output is written once (no atomics: bit-identical reruns). The
// tangents go straight from registers (a column's nZs x nMu values at a
// stride): staging them in shared memory halved the CTAs a SM and timed
// 19% slower.
//
// Bound of the tangent mode at the production shape (66 layers, 1,440,001
// columns, 9 altitudes, 1 secant, 30 angles, nD = 8): sweep B's 2.9e9 exp2
// as K2's (0.70 ms on the special-function units) with 7 FP32 ops each;
// dod read once, 3.04 GB, od, and the tangents, 0.78 GB: 4.2 GB, 1.26 ms
// at 3.35 TB/s, the bound. Each sweep waits on memory or the
// special-function units with five CTAs (ten warps) a SM (PERF.md has the
// timings).

#include <cuda_runtime.h>

namespace {

constexpr int TPB = 64;       // columns per CTA
constexpr int ACH = 32;       // downwelling angles carried per chunk
constexpr int MAX_ZS = 64;    // sensor altitudes (a 64-bit mask per layer)

constexpr float C1E4 = static_cast<float>(1.19104295315e-16 * 1e4);
constexpr float C2F = static_cast<float>(1.43877736830e-02);
constexpr float LOG2E = static_cast<float>(1.4426950408889634);

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one layer's step of a carry L over optical depth o at the exponent
// factor c = -secant log2(e): t = 2^(o c), L <- B + t (L - B)
__device__ __forceinline__ float carry_step(float o, float c, float carry,
                                            float b) {
  return fmaf(ex2_sfu(o * c), carry - b, b);
}

template <bool PLANCK>
__global__ void __launch_bounds__(TPB)
fused_tud_kernel(const float* __restrict__ od, const float* __restrict__ src,
                 const float* __restrict__ inv_t, int n_lay, int n_x,
                 const float* __restrict__ mus, int n_mu,
                 const int* __restrict__ snap, int n_zs,
                 const float* __restrict__ sec, const float* __restrict__ w,
                 int n_angles, int return_od, float* __restrict__ tau,
                 float* __restrict__ lu_out, float* __restrict__ ld_out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_snap = smem;                    // [n_lay + 1]
  float* s_b = reinterpret_cast<float*>(s_snap + n_lay + 1);  // [n_lay][TPB]
  const int R = n_zs * n_mu;
  float* s_tau = s_b + static_cast<size_t>(n_lay) * TPB;     // [TPB][R]
  float* s_lu = s_tau + TPB * R;                              // [TPB][R]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * TPB;
  const int k = k0 + tid;
  // lanes past the grid shadow its last column and store nothing
  const int kk = min(k, n_x - 1);

  // the sensor altitudes that snapshot after v layers, as one mask
  for (int v = tid; v <= n_lay; v += TPB) {
    unsigned long long m = 0;
    for (int zi = 0; zi < n_zs; ++zi)
      if (snap[zi] == v) m |= 1ull << zi;
    s_snap[v] = m;
  }
  // each column's source of layer l: computed or read once, by the first
  // up sweep (a layer ahead of its use), then kept in s_b (only this
  // thread reads its own)
  const float nu = PLANCK ? src[kk] * 100.0f : 0.0f;
  const float a3 = (nu * nu * nu) * C1E4;
  const float nuc2 = nu * C2F;
  auto source = [&](int l) {
    return PLANCK ? a3 / expm1f(nuc2 * inv_t[l])
                  : src[static_cast<size_t>(l) * n_x + kk];
  };
  if (n_mu == 0) {
    for (int l = 0; l < n_lay; ++l) s_b[l * TPB + tid] = source(l);
  }
  __syncthreads();

  // altitudes below the ground layer
  for (unsigned long long m = s_snap[0]; m; m &= m - 1) {
    const int zi = __ffsll(static_cast<long long>(m)) - 1;
    for (int j = 0; j < n_mu; ++j) {
      s_tau[tid * R + zi * n_mu + j] = return_od ? 0.0f : 1.0f;
      s_lu[tid * R + zi * n_mu + j] = 0.0f;
    }
  }

  // up pass: one sweep per slant secant
  for (int j = 0; j < n_mu; ++j) {
    const float m = mus[j];
    const float cm = -m * LOG2E;
    float cum = 0.0f, lu = 0.0f;
    float o = n_lay > 0 ? od[kk] : 0.0f;
    float b_next = j == 0 && n_lay > 0 ? source(0) : 0.0f;
#pragma unroll 1
    for (int l = 0; l < n_lay; ++l) {
      const float o_next =
          l + 1 < n_lay ? od[static_cast<size_t>(l + 1) * n_x + kk] : 0.0f;
      float b;
      if (j == 0) {
        b = b_next;
        s_b[l * TPB + tid] = b;
        if (l + 1 < n_lay) b_next = source(l + 1);
      } else {
        b = s_b[l * TPB + tid];
      }
      lu = carry_step(o, cm, lu, b);
      cum = cum + o;
      for (unsigned long long msk = s_snap[l + 1]; msk; msk &= msk - 1) {
        const int zi = __ffsll(static_cast<long long>(msk)) - 1;
        s_tau[tid * R + zi * n_mu + j] = return_od ? cum * m : expf(cum * -m);
        s_lu[tid * R + zi * n_mu + j] = lu;
      }
      o = o_next;
    }
  }
  __syncthreads();
  // the CTA's (columns, nZs, nMu) block of tau and Lu is one contiguous run
  const int n_cols = min(TPB, n_x - k0);
  const size_t base = static_cast<size_t>(k0) * R;
  for (int i = tid; i < n_cols * R; i += TPB) {
    tau[base + i] = s_tau[i];
    lu_out[base + i] = s_lu[i];
  }

  // down pass: angle chunks of ACH carries, top of the atmosphere to ground
  float ld = 0.0f;
  for (int a0 = 0; a0 < n_angles; a0 += ACH) {
    float c[ACH], carry[ACH];
#pragma unroll
    for (int a = 0; a < ACH; ++a) {
      c[a] = a0 + a < n_angles ? -sec[a0 + a] * LOG2E : 0.0f;
      carry[a] = 0.0f;
    }
    float o = n_lay > 0 ? od[static_cast<size_t>(n_lay - 1) * n_x + kk]
                        : 0.0f;
#pragma unroll 1
    for (int l = n_lay - 1; l >= 0; --l) {
      const float o_next =
          l > 0 ? od[static_cast<size_t>(l - 1) * n_x + kk] : 0.0f;
      const float b = s_b[l * TPB + tid];
#pragma unroll
      for (int a = 0; a < ACH; ++a)
        carry[a] = carry_step(o, c[a], carry[a], b);
      o = o_next;
    }
#pragma unroll
    for (int a = 0; a < ACH; ++a)
      if (a0 + a < n_angles) ld += carry[a] * w[a0 + a];
  }
  if (k < n_x) ld_out[k] = ld;
}

constexpr int TACH = 32;      // downwelling angles a chunk of sweep B
constexpr int DCH = 8;        // directions a chunk of sweep C
constexpr int LCH_A = 8;      // layers a load group of sweep A
constexpr int LCH_C = 4;      // layers a load group of sweep C
// CTAs a SM: the register cap that lets five in beside their shared memory
// (168 registers, 48 bytes spilled) timed 5% faster than 208 registers and
// four (NVIDIA H100, the Jacobian cell's shape)
constexpr int JVP_MIN_CTAS = 5;
constexpr float LN2 = static_cast<float>(0.6931471805599453);

__global__ void __launch_bounds__(TPB, JVP_MIN_CTAS)
fused_tud_kernel_jvp(const float* __restrict__ od, const float* __restrict__ x,
                     const float* __restrict__ inv_t, int n_lay, int n_x,
                     const float* __restrict__ mus, int n_mu,
                     const int* __restrict__ snap, int n_zs,
                     const float* __restrict__ sec,
                     const float* __restrict__ w, int n_angles,
                     const float* __restrict__ dod,
                     const float* __restrict__ dT, int n_dirs,
                     float* __restrict__ dtau, float* __restrict__ dlu,
                     float* __restrict__ dld) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_snap = smem;                    // [n_lay + 1]
  const size_t lt = static_cast<size_t>(n_lay) * TPB;
  // S_B takes the place of the prefix OD when one chunk holds every angle
  // (each column's slot is read before it is written), else its own
  const bool apart = n_angles > TACH;
  float* s_cum = reinterpret_cast<float*>(s_snap + n_lay + 1);  // [n_lay][TPB]
  float* s_sod = s_cum + lt;                                  // [n_lay][TPB]
  float* s_sb = apart ? s_sod + lt : s_cum;                   // [n_lay][TPB]
  float* s_dt = s_sod + (apart ? 2 : 1) * lt;                 // [n_lay][DCH]
  const int R = n_zs * n_mu;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * TPB;
  const int k = k0 + tid;
  const int kk = min(k, n_x - 1);
  const bool live = k < n_x;
  const size_t plane = static_cast<size_t>(n_lay) * n_x;

  for (int v = tid; v <= n_lay; v += TPB) {
    unsigned long long m = 0;
    for (int zi = 0; zi < n_zs; ++zi)
      if (snap[zi] == v) m |= 1ull << zi;
    s_snap[v] = m;
  }
  // the source (K2's arithmetic) and its temperature derivative, B (x / T)
  // (1 + 1 / expm1(x)) with 1 / expm1(x) = B / a3
  const float nu = x[kk] * 100.0f;
  const float a3 = (nu * nu * nu) * C1E4;
  const float r3 = 1.0f / a3;
  const float nuc2 = nu * C2F;
  auto source = [&](int l) { return a3 / expm1f(nuc2 * inv_t[l]); };

  // sweep A: exclusive prefix sums of od, ground up, in K2's order, the
  // loads of LCH_A layers issued together
  float total = 0.0f;
  for (int l0 = 0; l0 < n_lay; l0 += LCH_A) {
    float o[LCH_A];
#pragma unroll
    for (int i = 0; i < LCH_A; ++i)
      o[i] = l0 + i < n_lay ? od[static_cast<size_t>(l0 + i) * n_x + kk]
                            : 0.0f;
#pragma unroll
    for (int i = 0; i < LCH_A; ++i)
      if (l0 + i < n_lay) {
        s_cum[(l0 + i) * TPB + tid] = total;
        total = total + o[i];
      }
  }
  if (n_angles == 0)
    for (int l = 0; l < n_lay; ++l) {
      s_sod[l * TPB + tid] = 0.0f;
      s_sb[l * TPB + tid] = 0.0f;
    }

  // sweep B: Ld's sensitivities, top down, angles in chunks; the carries
  // hold w_a T_a(l + 1) and w_a V_a(l)
  for (int a0 = 0; a0 < n_angles; a0 += TACH) {
    float c[TACH], wa[TACH], tp[TACH], v[TACH];
#pragma unroll
    for (int a = 0; a < TACH; ++a) {
      const bool on = a0 + a < n_angles;
      c[a] = on ? -sec[a0 + a] * LOG2E : 0.0f;
      wa[a] = on ? w[a0 + a] : 0.0f;
      tp[a] = wa[a] * ex2_sfu(total * c[a]);
      v[a] = 0.0f;
    }
#pragma unroll 1
    for (int l = n_lay - 1; l >= 0; --l) {
      const float b = source(l);
      const float cl = s_cum[l * TPB + tid];
      float s_o = 0.0f, s_b = 0.0f;
#pragma unroll
      for (int a = 0; a < TACH; ++a) {
        const float tn = wa[a] * ex2_sfu(cl * c[a]);
        const float d = tn - tp[a];
        s_o = fmaf(c[a], fmaf(tp[a], b, -v[a]), s_o);
        s_b += d;
        v[a] = fmaf(d, b, v[a]);
        tp[a] = tn;
      }
      // c_a = -sec_a log2(e): S_od's sum of c_a (...) times -ln 2
      if (a0 == 0) {
        s_sod[l * TPB + tid] = -LN2 * s_o;
        s_sb[l * TPB + tid] = s_b;
      } else {
        s_sod[l * TPB + tid] = fmaf(-LN2, s_o, s_sod[l * TPB + tid]);
        s_sb[l * TPB + tid] += s_b;
      }
    }
  }
  __syncthreads();

  // sweep C: the up pass and the tangents, directions in chunks
  const int n_chunks = max(1, (n_dirs + DCH - 1) / DCH);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int d0 = ch * DCH;
    const int nd = min(DCH, n_dirs - d0);
    if (ch > 0) __syncthreads();        // the last chunk's reads of s_dt
    for (int i = tid; i < n_lay * DCH; i += TPB) {
      const int l = i / DCH, d = i % DCH;
      s_dt[i] = d < nd ? dT[static_cast<size_t>(d0 + d) * n_lay + l] : 0.0f;
    }
    __syncthreads();
    const float* dod0 = dod + static_cast<size_t>(d0) * plane + kk;
    // altitudes below the ground layer
    for (unsigned long long msk = s_snap[0]; msk; msk &= msk - 1) {
      const int zi = __ffsll(static_cast<long long>(msk)) - 1;
      for (int j = 0; j < n_mu; ++j) {
        const int r = zi * n_mu + j;
        if (live)
          for (int d = 0; d < nd; ++d) {
            const size_t at = (static_cast<size_t>(d0 + d) * n_x + k) * R + r;
            dtau[at] = 0.0f;
            dlu[at] = 0.0f;
          }
      }
    }
    float dl_d[DCH];
#pragma unroll
    for (int d = 0; d < DCH; ++d) dl_d[d] = 0.0f;
    for (int j = 0; j < n_mu; ++j) {
      const float m = mus[j];
      const float cm = -m * LOG2E;
      float cum = 0.0f, lu = 0.0f, dc[DCH], du[DCH];
#pragma unroll
      for (int d = 0; d < DCH; ++d) {
        dc[d] = 0.0f;
        du[d] = 0.0f;
      }
      // od and dod of LCH_C layers, loaded a group ahead of their use
      float o[LCH_C], dv[LCH_C][DCH], o_n[LCH_C], dv_n[LCH_C][DCH];
      auto load = [&](int l0, float (&og)[LCH_C], float (&dg)[LCH_C][DCH]) {
#pragma unroll
        for (int i = 0; i < LCH_C; ++i) {
          const bool in = l0 + i < n_lay;
          const size_t at = static_cast<size_t>(l0 + i) * n_x;
          og[i] = in ? od[at + kk] : 0.0f;
#pragma unroll
          for (int d = 0; d < DCH; ++d)
            dg[i][d] = in && d < nd ? dod0[static_cast<size_t>(d) * plane + at]
                                    : 0.0f;
        }
      };
      load(0, o, dv);
#pragma unroll 1
      for (int l0 = 0; l0 < n_lay; l0 += LCH_C) {
        load(l0 + LCH_C, o_n, dv_n);
#pragma unroll
        for (int i = 0; i < LCH_C; ++i) {
          const int l = l0 + i;
          if (l < n_lay) {
            const float b = source(l);
            const float xt = nuc2 * inv_t[l];
            const float dbdt = b * (xt * inv_t[l]) * fmaf(b, r3, 1.0f);
            const float t = ex2_sfu(o[i] * cm);
            const float diff = lu - b;
            const float g = -m * diff;
            const float so = s_sod[l * TPB + tid], sb = s_sb[l * TPB + tid];
#pragma unroll
            for (int d = 0; d < DCH; ++d) {
              const float db = dbdt * s_dt[l * DCH + d];
              du[d] = fmaf(t, fmaf(g, dv[i][d], du[d] - db), db);
              dc[d] += dv[i][d];
              if (j == 0) dl_d[d] = fmaf(so, dv[i][d], fmaf(sb, db, dl_d[d]));
            }
            lu = fmaf(t, diff, b);
            cum = cum + o[i];
            for (unsigned long long msk = s_snap[l + 1]; msk; msk &= msk - 1) {
              const int zi = __ffsll(static_cast<long long>(msk)) - 1;
              const int r = zi * n_mu + j;
              const float tv = expf(cum * -m);
              if (live)
#pragma unroll
                for (int d = 0; d < DCH; ++d)
                  if (d < nd) {
                    const size_t at =
                        (static_cast<size_t>(d0 + d) * n_x + k) * R + r;
                    dtau[at] = -m * dc[d] * tv;
                    dlu[at] = du[d];
                  }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < LCH_C; ++i) {
          o[i] = o_n[i];
#pragma unroll
          for (int d = 0; d < DCH; ++d) dv[i][d] = dv_n[i][d];
        }
      }
    }
    if (live)
#pragma unroll
      for (int d = 0; d < DCH; ++d)
        if (d < nd) dld[static_cast<size_t>(d0 + d) * n_x + k] = dl_d[d];
  }
}

}  // namespace

// src: the wavenumbers x (nX,) with planck != 0, else B (nL, nX); inv_t is
// read only with planck != 0.
extern "C" int radtxfr_fused_tud(const void* od, const void* src,
                                 const void* inv_t, int planck, int n_lay,
                                 int n_x, const void* mus, int n_mu,
                                 const void* snap, int n_zs, const void* sec,
                                 const void* w, int n_angles, int return_od,
                                 void* tau, void* lu, void* ld,
                                 void* stream) {
  if (n_x == 0) return 0;
  if (n_zs > MAX_ZS || n_lay < 0 || n_mu < 0 || n_angles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(unsigned long long) * (n_lay + 1) +
                      sizeof(float) * TPB *
                          (static_cast<size_t>(n_lay) + 2 * n_zs * n_mu);
  const dim3 grid((n_x + TPB - 1) / TPB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RADTXFR_LAUNCH_TUD(P)                                                \
  do {                                                                       \
    if (smem > 48 * 1024) {                                                  \
      const cudaError_t e = cudaFuncSetAttribute(                            \
          fused_tud_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
          static_cast<int>(smem));                                           \
      if (e != cudaSuccess) return static_cast<int>(e);                      \
    }                                                                        \
    fused_tud_kernel<P><<<grid, TPB, smem, s>>>(                             \
        static_cast<const float*>(od), static_cast<const float*>(src),       \
        static_cast<const float*>(inv_t), n_lay, n_x,                        \
        static_cast<const float*>(mus), n_mu, static_cast<const int*>(snap), \
        n_zs, static_cast<const float*>(sec), static_cast<const float*>(w),  \
        n_angles, return_od, static_cast<float*>(tau),                       \
        static_cast<float*>(lu), static_cast<float*>(ld));                   \
  } while (0)
  if (planck)
    RADTXFR_LAUNCH_TUD(true);
  else
    RADTXFR_LAUNCH_TUD(false);
#undef RADTXFR_LAUNCH_TUD
  return static_cast<int>(cudaGetLastError());
}


// The tangent mode: x (nX,), inv_t (nL,), dod (n_dirs, nL, nX), dT
// (n_dirs, nL); writes dtau, dlu (n_dirs, nX, nZs, nMu) and dld (n_dirs,
// nX).
extern "C" int radtxfr_fused_tud_jvp(
    const void* od, const void* x, const void* inv_t, int n_lay, int n_x,
    const void* mus, int n_mu, const void* snap, int n_zs, const void* sec,
    const void* w, int n_angles, const void* dod,
    const void* dT, int n_dirs, void* dtau, void* dlu, void* dld,
    void* stream) {
  if (n_x == 0) return 0;
  if (n_zs > MAX_ZS || n_lay < 0 || n_mu < 0 || n_angles < 0 || n_dirs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(unsigned long long) * (n_lay + 1) +
      sizeof(float) * ((n_angles > TACH ? 3 : 2) *
                           static_cast<size_t>(n_lay) * TPB +
                       static_cast<size_t>(n_lay) * DCH);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_tud_kernel_jvp, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_x + TPB - 1) / TPB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_tud_kernel_jvp<<<grid, TPB, smem, s>>>(
      static_cast<const float*>(od), static_cast<const float*>(x),
      static_cast<const float*>(inv_t), n_lay, n_x,
      static_cast<const float*>(mus), n_mu, static_cast<const int*>(snap),
      n_zs, static_cast<const float*>(sec), static_cast<const float*>(w),
      n_angles, static_cast<const float*>(dod),
      static_cast<const float*>(dT), n_dirs, static_cast<float*>(dtau),
      static_cast<float*>(dlu), static_cast<float*>(dld));
  return static_cast<int>(cudaGetLastError());
}
