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
