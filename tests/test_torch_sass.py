"""The issue-slot counts of ``radtxfr_tpu_torch/tools/sass.py`` on small
hand-written listings in ``nvdisasm --print-line-info``'s form: the parser
keeps each instruction's source line and drops the slow-path subroutines
and their call glue, and the counts take only the work instructions of the
functions that do the work, per copy of them."""

import pytest

from radtxfr_tpu_torch.tools import sass
from port_fixtures import one_torch_thread  # noqa: F401


def _listing(kernel, rows):
    """A listing of one kernel from ``rows``: (source line, opcode) pairs,
    or raw text lines (labels, subroutine headers)."""
    out = [f"\t.text.{kernel}:"]
    addr = 0
    for row in rows:
        if isinstance(row, str):
            out.append(row)
            continue
        line, op = row
        out.append(f'\t//## File "/src/k.cu", line {line}')
        out.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 16
    return "\n".join(out)


TUD_SRC = """\
__device__ __forceinline__ float ex2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float carry_step(float o, float c, float carry,
                                            float b) {
  return fmaf(ex2_sfu(o * c), carry - b, b);
}
__global__ void k() {
  auto source = [&](int l) {
    return PLANCK ? a3 / expm1f(nuc2 * inv_t[l])
                  : src[static_cast<size_t>(l) * n_x + kk];
  };
}
"""

TUD_ROWS = [
    (12, "LDG.E.CONSTANT R1, desc[UR4][R2.64]"), (12, "FMUL R3, R1, R4"),
    (12, "MUFU.EX2 R5, R3"), (12, "IADD3 R6, R6, 0x1, RZ"),
    (12, "MUFU.RCP R7, R5"), (12, "@P0 BRA `(.L_x_1)"), (12, "MOV R8, R7"),
    (12, "CALL.REL.NOINC `($__internal_0_$__cuda_sm3x_div_rn_noftz_f32)"),
    ".L_x_1:",
    (8, "FMUL R9, R10, R11"), (3, "MUFU.EX2 R12, R9"),
    (8, "FADD R13, R14, -R15"), (8, "FFMA R14, R12, R13, R15"),
    (8, "FMUL R9, R10, R16"), (3, "MUFU.EX2 R12, R9"),
    (8, "FADD R13, R17, -R15"), (8, "FFMA R17, R12, R13, R15"),
    (9, "BRA `(.L_x_2)"),
    "$__internal_0_$__cuda_sm3x_div_rn_noftz_f32:",
    (12, "FFMA R1, R2, R3, R4"), (12, "RET.REL.NODEC R2 `(k)"),
]


def test_parse_keeps_lines_and_drops_slow_paths():
    kern = "_Z16fused_tud_kernelILb1EEvPKf"
    parsed = sass.parse(_listing(kern, TUD_ROWS))
    instrs = sass.kernel(parsed, r"fused_tud_kernelILb1E")
    ops = [i.op for i in instrs]
    # the call's glue (MOV, CALL) and the subroutine after the body go
    assert not any(op.startswith(("CALL", "MOV", "RET")) for op in ops)
    assert ops.count("FFMA") == 2 and len(ops) == 15
    assert instrs[0] == ("k.cu", 12, "LDG.E.CONSTANT", False)
    assert instrs[5].pred and instrs[5].op == "BRA"
    with pytest.raises(ValueError, match="0 kernels"):
        sass.kernel(parsed, "no_such_kernel")


@pytest.mark.parametrize("n_mu,n_angles", [(1, 30), (2, 7)])
def test_k2_counts_the_source_and_the_carry_steps(n_mu, n_angles):
    instrs = sass.parse(_listing("_Z1kILb1E", TUD_ROWS))["_Z1kILb1E"]
    per = sass.k2_instructions(instrs, TUD_SRC, n_mu, n_angles, True)
    # source: LDG, FMUL, MUFU.EX2, MUFU.RCP (not IADD3 or the branch) for
    # its one reciprocal; a step: FMUL, MUFU.EX2, FADD, FFMA for each of
    # its two copies (not the loop's BRA)
    assert per["source"] == 4 and per["step"] == 4
    assert per["total"] == 1 + 4 + n_mu * 5 + n_angles * 4


XS_SRC = """\
__device__ __forceinline__ float asym_re_w(float x, const float4& b) {
  return x;
}
template <bool WANT_IM>
__device__ __forceinline__ void weideman_w(float x, float y,
                                           float* re, float* im) {
  const float inv_e = 1.0f / x;
  for (int k = 2; k <= n_wei; ++k) {
    const float t = pr * zr - pi * zi + wei[k];
  }
  *re = 1.0f / y;
}
__device__ __forceinline__ float far_re_w(float x, float y, const float4& b) {
  return 1.0f / x;
}
__device__ __forceinline__ void far_kl(float x, float y, const float4& b,
                                       float* K, float* Lw) {
  *K = 1.0f / x;
}
template <int MODE>
__device__ __forceinline__ float voigt_value(float u, const LineConst& c,
                                             const float* wei, int n_wei) {
  const float x = (u - c.a.x) * c.a.y;
}
"""

# one copy of a core evaluation: voigt_value's offset and region test, the
# Weideman series (its loop unrolled by two: one LDS.64 for two
# coefficients) and the asymptotic form subtracted
CORE_COPY = [
    (23, "FADD R1, R2, -R3"), (23, "FMUL R1, R1, R4"),
    (23, "FSETP.GEU.AND P0, PT, R5, 15, PT"), (23, "ISETP.NE.AND P1, PT, R6"),
    (7, "MUFU.RCP R7, R8"), (7, "FFMA R9, R7, R8, R10"),
    (9, "LDS.64 R10, [R11]"), (9, "FFMA R12, R13, R14, R10"),
    (9, "FFMA R12, R15, R16, R12"), (9, "FMUL R17, R13, R16"),
    (9, "FFMA R12, R13, R14, R11"), (9, "FFMA R12, R15, R16, R12"),
    (9, "FMUL R17, R13, R16"), (9, "IADD3 R18, R18, 0x2, RZ"),
    (9, "BRA `(.L_x_3)"),
    (11, "MUFU.RCP R19, R20"), (11, "FMUL R21, R19, R22"),
    (1, "FMUL R23, R24, R24"), (1, "MUFU.RCP R25, R23"),
    (1, "FFMA R26, R25, R23, R27"), (1, "ISETP.GT.AND P2, PT, R28"),
]


def test_k1_counts_one_evaluation_per_copy():
    kern = "_Z18fused_xsect_kernelILi1ELb0EEvPKi"
    instrs = sass.parse(_listing(kern, CORE_COPY * 2))[kern]
    c = sass.k1_eval_instructions(instrs, XS_SRC, 1, 16)
    # two copies (asym_re_w's MUFU.RCP); a Weideman term 7 work
    # instructions over two coefficients; the series' set-up and finish 4,
    # voigt_value 3, asym_re_w 3, and the FFMA that scales and adds
    assert c["weideman_term"] == 3.5
    assert c["in"] == 3 + (4 + 15 * 3.5) + 3 + 1
    # outside |x| + y < 15 core adds nothing: only the region test
    assert c["out"] == 3
