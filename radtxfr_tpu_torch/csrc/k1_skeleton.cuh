// The staging and culling helpers of K1's CTA skeleton (fused_xsect.cu),
// shared by K1, K7 (the unfused kernel, same file) and K3 (the Voigt
// tangent, fused_xsect_jvp.cu): the cp.async copies of the staging ring and
// the integer window ranges a staged (slot, layer) pair is culled by.
// _build.py hashes this header into the name of every library whose source
// includes it, so an edit rebuilds them.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float REGION_BOUND = 15.0f;   // hum1_wei's |x| + y < 15
constexpr int RING = 3;                 // chunks of slot data in flight

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

}  // namespace
