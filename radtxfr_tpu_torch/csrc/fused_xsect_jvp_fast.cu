// K3 and K4 with the TPU kernels' fast reciprocal (fast_rcp=True, the
// default of JAX's builders): fused_xsect_jvp.cu's kernels instantiated
// with FAST true, at the sites where pallas_xsect.py calls _rcp(., fast)
// (_asym_K_grads, _weideman_K_grads), in a library of their own (entries
// radtxfr_fused_xsect_jvp_fast and radtxfr_fused_sdvoigt_jvp_fast).

#define RADTXFR_FAST 1
#include "fused_xsect_jvp.cu"
