// K1 and K7 with the TPU kernels' fast reciprocal (fast_rcp=True, the
// default of JAX's builders): fused_xsect.cu's kernels instantiated with
// FAST true, at the sites where pallas_xsect.py calls _rcp(., fast), in a
// library of their own (entries radtxfr_fused_xsect_fast and
// radtxfr_unfused_xsect_fast), built beside fused_xsect.cu's in parallel.

#define RADTXFR_FAST 1
#include "fused_xsect.cu"
