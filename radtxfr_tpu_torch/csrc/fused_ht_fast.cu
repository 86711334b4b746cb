// K5 with the TPU kernels' fast reciprocal (fast_rcp=True, the default of
// JAX's builders): fused_ht.cu's K5 instantiated with FAST true, at the
// reciprocals of the w(Z) forms where pallas_xsect.py::_voigt_w_KL calls
// _rcp(., fast), in a library of its own (entry radtxfr_fused_ht_fast).
// K6 is not built here: JAX's tangent kernel forces fast=False.

#define RADTXFR_FAST 1
#include "fused_ht.cu"
