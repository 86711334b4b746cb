// P1/P2: the FP32 issue-rate probe for Hopper (sm_90a).
//
// Replaces the JAX package's VPU-peak probes: bench.py::measured_vpu_peak
// (its probe pallas_call) and tools/vpu_peak_probe.py::make_probe. Those ran
// dependent and independent a*y+b / y*a / y+b chains on a register-resident
// float32 block to measure the TPU's elementwise issue rate, the
// denominator of its rooflines. On the H100 the same chains measure the
// FP32 pipe (132 SMs x 128 lanes, one FFMA per lane and clock: 67 TFLOP/s
// on the data sheet at the boost clock), the peak every kernel's bound in
// chip_smoke.py divides operations by.
//
// One kernel, templated on the operation (OP), the number of independent
// chains per thread (NCH) and the unrolled depth (DEPTH); `iters` repeats
// the unrolled body at run time. One thread per element, enough CTAs for
// every SM's full thread count, the chains in registers. Each step is one
// instruction written as an intrinsic, so nothing is contracted or
// reassociated: FMA __fmaf_rn(a, y, b) (one FFMA, 2 flops), MUL
// __fmul_rn(y, a), ADD __fadd_rn(y, b), ADDMUL (y + b) * a (an FADD and an
// FMUL). `a` and `b` are arguments, so the compiler cannot fold the chain,
// and each thread writes the sum of its chains, so none is dead. A rate
// above the data sheet's means a chain was folded after all: the wrapper
// (radtxfr_tpu_torch/tools/fp32_peak.py) then fails. Do not build with
// --use_fast_math.
//
// Bound: FP32 issue by construction (NCH reads and one write per thread,
// depth x iters x NCH steps in registers).

#include <cuda_runtime.h>

namespace {

constexpr int PROBE_THREADS = 256;

// the order of radtxfr_tpu_torch/tools/fp32_peak.py: OPS
enum Op { FMA = 0, MUL, ADD, ADDMUL };

template <int OP>
__device__ __forceinline__ float step(float y, float a, float b) {
  if (OP == FMA) return __fmaf_rn(a, y, b);
  if (OP == MUL) return __fmul_rn(y, a);
  if (OP == ADD) return __fadd_rn(y, b);
  return __fmul_rn(__fadd_rn(y, b), a);
}

template <int OP, int NCH, int DEPTH>
__global__ void __launch_bounds__(PROBE_THREADS)
peak_probe_kernel(const float* __restrict__ y0, float a, float b, int iters,
                  int n, float* __restrict__ out) {
  const int i = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n) return;
  float y[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) y[k] = y0[static_cast<size_t>(i) * NCH + k];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) y[k] = step<OP>(y[k], a, b);
    }
  }
  float acc = y[0];
#pragma unroll
  for (int k = 1; k < NCH; ++k) acc = __fadd_rn(acc, y[k]);
  out[i] = acc;
}

template <int OP, int NCH>
cudaError_t launch(int depth, const float* y0, float a, float b, int iters,
                   int n, float* out, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n + PROBE_THREADS - 1) /
                                              PROBE_THREADS);
  if (depth == 8)
    peak_probe_kernel<OP, NCH, 8><<<grid, PROBE_THREADS, 0, s>>>(
        y0, a, b, iters, n, out);
  else if (depth == 256)
    peak_probe_kernel<OP, NCH, 256><<<grid, PROBE_THREADS, 0, s>>>(
        y0, a, b, iters, n, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// op: FMA 0, MUL 1, ADD 2, ADDMUL 3; n_chains 1, 2 or 4 (the suite's
// mixes); depth 8 (the checks) or 256 (the timed runs); y0 (n, n_chains)
// float32 chain starts, out (n,) float32.
extern "C" int radtxfr_fp32_probe(int op, int n_chains, int depth,
                                  const void* y0, float a, float b, int iters,
                                  int n, void* out, void* stream) {
  if (n < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* y = static_cast<const float*>(y0);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = op * 8 + n_chains;
  switch (key) {
    case FMA * 8 + 1: return launch<FMA, 1>(depth, y, a, b, iters, n, o, s);
    case FMA * 8 + 2: return launch<FMA, 2>(depth, y, a, b, iters, n, o, s);
    case FMA * 8 + 4: return launch<FMA, 4>(depth, y, a, b, iters, n, o, s);
    case MUL * 8 + 1: return launch<MUL, 1>(depth, y, a, b, iters, n, o, s);
    case MUL * 8 + 2: return launch<MUL, 2>(depth, y, a, b, iters, n, o, s);
    case ADD * 8 + 1: return launch<ADD, 1>(depth, y, a, b, iters, n, o, s);
    case ADDMUL * 8 + 4:
      return launch<ADDMUL, 4>(depth, y, a, b, iters, n, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
