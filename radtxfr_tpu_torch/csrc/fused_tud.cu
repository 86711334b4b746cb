// K2: fused transmittance / upwelling / downwelling composition (sm_90a).
//
// Replaces radtxfr_tpu/kernels/pallas_tud.py::_build_kernel (launcher
// tud_compose_pallas, wrapper products/tud.py::make_tud_pallas_fn). For each
// wavenumber column nu = 100 x:
//   * the Planck source of every layer, B_l = c1 1e4 nu^3 / expm1(c2 nu / T_l)
//     (units of core/planck.py::planckian, µW/(cm^2 sr cm^-1));
//   * the up pass, once per slant secant m, ground to top:
//     Lu <- t Lu + (1 - t) B_l, t = exp(-m od_l), cum += od_l, snapshotting
//     tau = exp(-m cum) (or the path OD m cum) and Lu at each sensor
//     altitude's layer count; altitudes below the ground layer give tau = 1
//     (path OD 0) and Lu = 0;
//   * the down pass over the quadrature angles, top to ground:
//     Ld_a <- t_a Ld_a + (1 - t_a) B_l, then Ld = sum_a w_a Ld_a.
//
// Shape. One thread per column, TPB columns per CTA (~11k CTAs at the
// production 1.44M-point grid). The carries stay in registers: (cum, Lu) per
// secant, and up to ACH downwelling carries per angle chunk (the 30 angles
// of the production run are one chunk). Each pass reads od[:, nu] once,
// coalesced across the warp; outputs go straight into tau/Lu (nX, nZs, nMu)
// and Ld (nX,), with the ragged last CTA masked. No shared memory, no
// padded output rows, no pad-with-1000 columns: those existed for the TPU's
// (8, 128) tiling. Every output is written once: no atomics, bit-identical
// reruns.
//
// Bound. Per column and layer the kernel reads 4 bytes of od per pass and
// evaluates nMu + nA exponentials plus one expm1 per pass: at the
// production shape 3.1e9 special-function exp2 (0.75 ms at 16 per clock
// per SM) and ~4.3e10 FP32 lane-ops (~8 per expf, ~20 per expm1f, ~5 per
// carry update: 0.64 ms at 67 TFLOP/s), against 0.15 ms for the 495 MB it
// must move. So the special-function units bound it, FP32 issue close
// behind, not the 380 MB of od it reads twice (chip_smoke.py phase 4
// states the bound). The design keeps every carry in registers and
// recomputes the Planck source per pass (one expm1 per layer) rather than
// storing it.
//
// Planck uses expm1f: the Pallas kernel uses exp - 1 only because Mosaic has
// no expm1 lowering (pallas_tud.py:40-43).

#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;    // columns per CTA
constexpr int ACH = 32;     // downwelling angles carried per chunk

constexpr float C1E4 = static_cast<float>(1.19104295315e-16 * 1e4);
constexpr float C2F = static_cast<float>(1.43877736830e-02);

__global__ void __launch_bounds__(TPB)
fused_tud_kernel(const float* __restrict__ od, const float* __restrict__ x,
                 const float* __restrict__ inv_t, int n_lay, int n_x,
                 const float* __restrict__ mus, int n_mu,
                 const int* __restrict__ snap, int n_zs,
                 const float* __restrict__ sec, const float* __restrict__ w,
                 int n_angles, int return_od, float* __restrict__ tau,
                 float* __restrict__ lu_out, float* __restrict__ ld_out) {
  const int k = blockIdx.x * TPB + threadIdx.x;
  if (k >= n_x) return;
  const float nu = x[k] * 100.0f;
  const float a3 = (nu * nu * nu) * C1E4;
  const float nuc2 = nu * C2F;
  const size_t R = static_cast<size_t>(n_zs) * n_mu;
  float* tau_k = tau + static_cast<size_t>(k) * R;
  float* lu_k = lu_out + static_cast<size_t>(k) * R;

  for (int zi = 0; zi < n_zs; ++zi) {
    if (snap[zi] == 0) {
      for (int j = 0; j < n_mu; ++j) {
        tau_k[zi * n_mu + j] = return_od ? 0.0f : 1.0f;
        lu_k[zi * n_mu + j] = 0.0f;
      }
    }
  }

  // up pass: one sweep per slant secant
  for (int j = 0; j < n_mu; ++j) {
    const float m = mus[j];
    float cum = 0.0f, lu = 0.0f;
    for (int l = 0; l < n_lay; ++l) {
      const float o = od[static_cast<size_t>(l) * n_x + k];
      const float b = a3 / expm1f(nuc2 * inv_t[l]);
      const float t = expf(o * -m);
      lu = t * lu + (1.0f - t) * b;
      cum = cum + o;
      for (int zi = 0; zi < n_zs; ++zi) {
        if (snap[zi] == l + 1) {
          tau_k[zi * n_mu + j] = return_od ? cum * m : expf(cum * -m);
          lu_k[zi * n_mu + j] = lu;
        }
      }
    }
  }

  // down pass: angle chunks of ACH carries, top of the atmosphere to ground
  float ld = 0.0f;
  for (int a0 = 0; a0 < n_angles; a0 += ACH) {
    const int na = min(ACH, n_angles - a0);
    float nsec[ACH], carry[ACH];
#pragma unroll
    for (int a = 0; a < ACH; ++a) {
      nsec[a] = a < na ? -sec[a0 + a] : 0.0f;
      carry[a] = 0.0f;
    }
    for (int l = n_lay - 1; l >= 0; --l) {
      const float o = od[static_cast<size_t>(l) * n_x + k];
      const float b = a3 / expm1f(nuc2 * inv_t[l]);
#pragma unroll
      for (int a = 0; a < ACH; ++a) {
        if (a < na) {
          const float t = expf(o * nsec[a]);
          carry[a] = t * carry[a] + (1.0f - t) * b;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < ACH; ++a)
      if (a < na) ld += carry[a] * w[a0 + a];
  }
  ld_out[k] = ld;
}

}  // namespace

extern "C" int radtxfr_fused_tud(const void* od, const void* x,
                                 const void* inv_t, int n_lay, int n_x,
                                 const void* mus, int n_mu, const void* snap,
                                 int n_zs, const void* sec, const void* w,
                                 int n_angles, int return_od, void* tau,
                                 void* lu, void* ld, void* stream) {
  if (n_x == 0) return 0;
  const dim3 grid((n_x + TPB - 1) / TPB);
  fused_tud_kernel<<<grid, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(od), static_cast<const float*>(x),
      static_cast<const float*>(inv_t), n_lay, n_x,
      static_cast<const float*>(mus), n_mu, static_cast<const int*>(snap),
      n_zs, static_cast<const float*>(sec), static_cast<const float*>(w),
      n_angles, return_od, static_cast<float*>(tau), static_cast<float*>(lu),
      static_cast<float*>(ld));
  return static_cast<int>(cudaGetLastError());
}
