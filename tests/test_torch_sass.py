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


K3_SRC = """\
__device__ __forceinline__ KGrads asym_k_grads(float x, float y,
                                               const float4& b) {
  const float inv = 1.0f / x;
  return g;
}
__device__ __forceinline__ KGrads weideman_k_grads(float x, float y,
                                                   const float* wei,
                                                   int n_wei) {
  const float inv_e = 1.0f / x;
  for (int k = 2; k <= n_wei; ++k) {
    const float tpr = pr * zr - pi * zi + wei[k];
  }
  return g;
}
template <bool CORE>
__device__ __forceinline__ float tangent_term(float u, const LineConst& c,
                                              const float4& t) {
  const float x = (u - c.a.x) * c.a.y;
  const KGrads g = CORE ? weideman_k_grads(x) : asym_k_grads(x);
  return t.x * g.K - t.y * G + t.z * g.Ky - t.w * g.Kx;
}
"""

# a copy of tangent_term<true> (the region test, Weideman with its loop
# unrolled by two, the asymptotic form) and one of tangent_term<false>
K3_COPIES = [
    (18, "FADD R1, R2, -R3"), (18, "FMUL R1, R1, R4"),
    (19, "FADD R5, |R1|, R6"), (19, "FSETP.GEU.AND P0, PT, R5, 15, PT"),
    (9, "MUFU.RCP R7, R8"), (9, "FFMA R9, R7, R8, R10"),
    (11, "LDS.64 R10, [R11]"), (11, "FFMA R12, R13, R14, R10"),
    (11, "FFMA R12, R15, R16, R12"), (11, "FMUL R17, R13, R16"),
    (10, "IADD3 R18, R18, 0x2, RZ"), (10, "BRA `(.L_x_3)"),
    (3, "MUFU.RCP R19, R20"), (3, "FMUL R21, R19, R22"),
    (20, "FMUL R23, R24, R25"), (20, "FFMA R23, -R26, R27, R23"),
    (20, "FFMA R23, R28, R29, R23"), (20, "FFMA R23, -R30, R31, R23"),
    (18, "FADD R1, R2, -R3"), (18, "FMUL R1, R1, R4"),
    (3, "MUFU.RCP R19, R20"), (3, "FMUL R21, R19, R22"),
    (20, "FMUL R23, R24, R25"), (20, "FFMA R23, -R26, R27, R23"),
    (20, "FFMA R23, R28, R29, R23"), (20, "FFMA R23, -R30, R31, R23"),
]


def test_k3_counts_one_evaluation_and_one_direction():
    kern = "_ZN12_GLOBAL__N_122fused_xsect_jvp_kernelEPKi"
    instrs = sass.parse(_listing(kern, K3_COPIES))[kern]
    c = sass.k3_eval_instructions(instrs, K3_SRC, 16)
    # two copies (asym_k_grads' MUFU.RCP): tangent_term's offset and region
    # test 6 over two copies; Weideman 2 outside its loop, a term 4 work
    # instructions over two coefficients; the asymptotic form 2; a
    # direction's four-coefficient line 4 and the FADD that adds it
    assert c["weideman_term"] == 2.0
    assert c["in"] == 3 + 2 + 15 * 2.0
    assert c["out"] == 3 + 2
    assert c["dir"] == 4 + 1


LD_SRC = """\
template <int MODE>
__device__ __forceinline__ float ld_value(float u, const LineConst& c) {
  const float x = (u - c.a.x) * c.a.y;
  if (MODE == LORENTZ) return INV_PI * (1.0f / (c.b.x + x * x));
  const float t = x * c.b.x;
  return expf((-LN2_HAPI * t) * t);
}
"""


@pytest.mark.parametrize("mode,rows,per", [
    (7, [(3, "FADD R1, R2, -R3"), (3, "FMUL R1, R1, R4"),
         (4, "FFMA R5, R1, R1, R6"), (4, "MUFU.RCP R7, R5"),
         (4, "FFMA R8, -R5, R7, 1"), (4, "@P0 BRA `(.L_x_1)"),
         (4, "FMUL R9, R7, R10")], 6 + 1),
    (8, [(3, "FADD R1, R2, -R3"), (3, "FMUL R1, R1, R4"),
         (5, "FMUL R5, R1, R6"), (6, "FMUL R7, R5, R8"),
         (6, "FFMA.SAT R9, R7, R10, 0.5"), (6, "MUFU.EX2 R11, R9"),
         (6, "FMUL R12, R11, R13")], 7 + 1)])
def test_lorentz_and_doppler_count_per_copy(mode, rows, per):
    kern = f"_Z18fused_xsect_kernelILi{mode}ELb0EEvPKi"
    instrs = sass.parse(_listing(kern, rows * 2))[kern]
    # two copies (the reciprocal's or expf's one MUFU each), plus the FFMA
    # that scales and adds each evaluation
    assert sass.ld_eval_instructions(instrs, LD_SRC, mode) == {"in": per,
                                                               "out": per}


HT_SRC = """\
template <class T>
__device__ __forceinline__ Cx<T> w_wei(const T& x, const T& y,
                                       const float* wei, int n_wei) {
  const T inv_e = recip(x);
  for (int k = 2; k <= n_wei; ++k) {
    const T t = pr * zr + wei[k];
  }
  return {recip(y), t};
}
template <class T>
__device__ __forceinline__ Cx<T> w_asym(const T& x, const T& y) {
  return {recip(x * y), y};
}
template <class T>
__device__ __forceinline__ Cx<T> voigt_w(const T& x, const T& y, bool far) {
  if (!far && x + y < 15) return w_wei(x, y);
  return w_asym(x, y);
}
template <class T>
__device__ __forceinline__ Cx<T> cpf3(const T& x, const T& y) {
  return {x / y, y};
}
template <class T>
__device__ __forceinline__ HtPair<T> ht_pair(const T* k) {
  h.rc = RPI * k[0];
  if (!h.part1) ht_pair234(h, k);
}
template <class T>
__device__ __forceinline__ void ht_pair234(HtPair<T>& h, const T* k) {
  h.ic2 = cinv(c2t);
}
template <class T>
__device__ __forceinline__ Cx<T> ht_b1_big(const Cx<T>& z1) {
  return cinv(z1);
}
template <class T>
__device__ __forceinline__ Cx<T> ht_b1_small(const Cx<T>& z1) {
  return cmul(z1, z1);
}
template <class T>
__device__ __forceinline__ void ht_part1(const Cx<T>& z1, bool far) {
  const Cx<T> w1 = voigt_w(z1.r, z1.i, far);
  B = mag(z1) > 4.0e3f ? ht_b1_big(z1) : ht_b1_small(z1);
}
template <class T>
__device__ __forceinline__ void ht_part4(const Cx<T>& sxy, bool far) {
  bool use3 = false;
  if (!far) {
    use3 = mag(Z1) > 8.0f;
  }
  const Cx<T> w14 = voigt_w(Z1.r, Z1.i, far);
  const Cx<T> w24 = voigt_w(Z2.r, Z2.i, far);
  B = cmul(w14, w24);
}
template <class T>
__device__ __forceinline__ void ht_part234(const Cx<T>& t0, bool far) {
  const Cx<T> sxy = csqrt(X);
  ht_part4(sxy, far);
}
template <class T>
__device__ __forceinline__ T ht_ls(const Cx<T>& A) {
  return A.r * INV_PI;
}
template <class T>
__device__ __forceinline__ T pcqsdhc(float dnu, bool far) {
  const Cx<T> t0 = {h.k1, (-dnu) + h.k2};
  if (h.part1) ht_part1(z1, far);
  else ht_part234(t0, z1, far);
  return ht_ls(A);
}
__device__ __forceinline__ float accumulate(float sum, const Rn& s,
                                            const Rn& ls) {
  return sum + __fmul_rn(s.v, ls.v);
}
__device__ __forceinline__ float accumulate(float sum, const Dual<1>& s,
                                            const Dual<1>& ls) {
  return sum + v;
}
__global__ void k() {
  sum = accumulate(sum, s, pcqsdhc(dnu, far));
}
"""


def _gi_listing(kernel, rows, file="fused_ht.cu"):
    """A listing of one kernel in ``nvdisasm --print-line-info-inline``'s
    form from ``rows``: (chain of source lines, innermost first, opcode),
    all in ``file``."""
    out = [f"\t.text.{kernel}:"]
    for addr, (chain, op) in enumerate(rows):
        for a, b in zip(chain, chain[1:]):
            out.append(f'\t//## File "/src/{file}", line {a} inlined '
                       f'at "/src/{file}", line {b}')
        out.append(f'\t//## File "/src/{file}", line {chain[-1]}')
        out.append(f"        /*{16 * addr:04x}*/                   {op} ;")
    return "\n".join(out)


def _wei_copy(site):
    """One Weideman copy inlined through voigt_w at ``site`` (a chain):
    its two reciprocals and a loop of two coefficients (one LDS.64)."""
    return [((4, 16) + site, "MUFU.RCP R1, R2"), ((4, 16) + site, "FFMA"),
            ((6, 16) + site, "LDS.64 R4, [R5]"), ((6, 16) + site, "FFMA"),
            ((6, 16) + site, "FFMA"), ((6, 16) + site, "FFMA"),
            ((5, 16) + site, "IADD3 R6, R6, 0x2, RZ"),
            ((8, 16) + site, "MUFU.RCP R7, R8"), ((8, 16) + site, "FMUL")]


def _asym_copy(site):
    """One asymptotic copy through voigt_w at ``site``, with the region
    test (two work instructions) it follows."""
    return [((16,) + site, "FADD"), ((16,) + site, "FSETP.GEU.AND P0"),
            ((12, 17) + site, "FMUL"), ((12, 17) + site, "MUFU.RCP R1, R2"),
            ((12, 17) + site, "FFMA")]


P1, P4A, P4B = (42, 67, 80), (51, 58, 68, 80), (52, 58, 68, 80)
HT_ROWS = ([((80,), "FFMA"), ((66, 80), "FADD")]
           + _wei_copy(P1) + _asym_copy(P1)
           + [((43, 67, 80), "FSETP.GT.AND P1"), ((200, 43, 67, 80), "FMUL"),
              ((34, 43, 67, 80), "MUFU.RCP R9, R10"), ((34, 43, 67, 80),
                                                       "FFMA"),
              ((38, 43, 67, 80), "FMUL"),
              ((57, 68, 80), "MUFU.RSQ R11, R12"), ((57, 68, 80), "FMUL"),
              ((200, 49, 58, 68, 80), "FMUL"), ((49, 58, 68, 80), "FSETP"),
              ((53, 58, 68, 80), "FMUL"), ((53, 58, 68, 80), "FFMA")]
           + _wei_copy(P4A) + _asym_copy(P4A) + _asym_copy(P4B)
           + [((62, 69, 80), "FMUL"), ((73, 80), "FMUL"), ((73, 80), "FADD"),
              ((25, 90), "FMUL"), ((30, 26, 90), "MUFU.RCP R13, R14"),
              ((30, 26, 90), "FFMA"), ((100, 90), "FADD")])


def test_parse_keeps_the_inlining_chain():
    kern = "_Z15fused_ht_kernelILb0EEv"
    instrs = sass.parse(_gi_listing(kern, HT_ROWS))[kern]
    assert len(instrs) == len(HT_ROWS)
    # the innermost frame is the instruction's line; the chain the rest
    i = instrs[2]
    assert (i.file, i.line) == ("fused_ht.cu", 4)
    assert i.chain == tuple(("fused_ht.cu", n) for n in (4, 16) + P1)
    assert instrs[0].chain == (("fused_ht.cu", 80),)


@pytest.mark.parametrize("n_wei", [16, 8])
def test_ht_counts_each_piece_per_copy(n_wei):
    kern = "_Z15fused_ht_kernelILb0EEv"
    instrs = sass.parse(_gi_listing(kern, HT_ROWS))[kern]
    c = sass.ht_eval_instructions(instrs, HT_SRC, n_wei)
    # two Weideman copies (four reciprocals), three asymptotic ones; the
    # loops' 8 work instructions load 4 coefficients (two LDS.64)
    assert c["weideman_term"] == 2.0
    # voigt_w's region test 2 a copy; Weideman's set-up and finish 4
    assert c["w_wei"] == 2 + 4 + (n_wei - 1) * 2
    assert c["w_asym"] == 2 + 3
    # pcqsdhc 1 + ht_ls 1, ht_part234 2, ht_part4 2 (its CPF3 test apart)
    assert c["part4"] == 6 and c["cpf3_test"] == 2
    # ht_part1 2 (with its helper's FMUL), and b1_small 1 or b1_big 2
    assert c["part1"] == 5 and c["part1_big"] == 6
    assert c["pair4"] == 3 and c["pair1"] == 1 and c["acc"] == 2


K4_SRC = """\
__device__ __forceinline__ float xm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ KGrads sd_k_wei(float x, float y, const float* wei,
                                           int n_wei) {
  const float inv_e = xd(1.0f, x);
  for (int k = 2; k <= n_wei; ++k) {
    const float tpr = xa(xm(pr, zr), wei[k]);
  }
  return g;
}
__device__ __forceinline__ KGrads sd_k_asym(float x, float y) {
  const float inv = xd(1.0f, xm(x, y));
  return g;
}
__device__ __forceinline__ KGrads sd_k_grads(float x, float y,
                                             const float* wei, int n_wei) {
  if (xa(fabsf(x), y) < REGION_BOUND) return sd_k_wei(x, y, wei, n_wei);
  return sd_k_asym(x, y);
}
__device__ __forceinline__ SdPoint sd_point(float u, const SdPair& q,
                                            float dx) {
  s.xi = xm(u, dx);
  s.us = __fsqrt_rn(xm(s.xi, s.xi));
  return s;
}
__device__ __forceinline__ float sd_term(const SdPoint& s, const KGrads& g1,
                                         const KGrads& g2, const SdPair& q) {
  const float dSr = xd(xm(s.xi, s.us), s.den);
  return xa(dSr, q.b.x);
}
__global__ void k() {
  const SdPoint s = sd_point(u, q, dx);
  const KGrads g1 = sd_k_asym(-s.vs, xs(s.us, q.a.w));
  sum = in ? sum + sd_term(s, g1, g2, q) : sum;
  const SdPoint s = sd_point(u, q, dx);
  const KGrads g1 = sd_k_grads(-s.vs, y1, s_wei, n_wei);
  sum += sd_term(s, g1, g2, q);
}
"""


def _k4_point(site):
    """One sd_point copy at kernel line ``site``: its three square roots
    and two more work instructions (one through xm)."""
    return [((1, 21, site), "FMUL"), ((22, site), "MUFU.RSQ R1, R2"),
            ((22, site), "MUFU.RSQ R3, R4"), ((22, site), "MUFU.RSQ R5, R6"),
            ((22, site), "FFMA"), ((22, site), "IADD3 R7, R7, 0x1, RZ")]


def _k4_asym(chain):
    return [((11,) + chain, "MUFU.RCP R1, R2"), ((1, 11) + chain, "FMUL"),
            ((11,) + chain, "FFMA")]


def _k4_kx(site):
    """One sd_k_grads copy at kernel line ``site``: the region test, a
    Weideman copy (its loop unrolled by two: one LDS.64 for two
    coefficients) and an asymptotic one."""
    w = (16, site)
    return ([((16, site), "FADD"), ((16, site), "FSETP.GEU.AND P0"),
             ((4,) + w, "MUFU.RCP R1, R2"), ((4,) + w, "FFMA"),
             ((6,) + w, "LDS.64 R4, [R5]"), ((1, 6) + w, "FMUL"),
             ((1, 6) + w, "FMUL"), ((6,) + w, "FADD"),
             ((5,) + w, "IADD3 R6, R6, 0x2, RZ"), ((8,) + w, "FMUL")]
            + _k4_asym((17, site)))


def _k4_term(site):
    return [((27, site), "MUFU.RCP R1, R2"), ((27, site), "MUFU.RCP R3, R4"),
            ((1, 27, site), "FMUL"), ((28, site), "FADD")]


# the far span's evaluation (two asymptotic CPF points) and the near span's
# (two region-tested ones), each with its sd_point and sd_term and the
# kernel's own accumulate
K4_ROWS = (_k4_point(31) + _k4_asym((32,)) + _k4_asym((32,)) + _k4_term(33)
           + [((33,), "FADD"), ((33,), "FSEL")]
           + _k4_point(34) + _k4_kx(35) + _k4_kx(35) + _k4_term(36)
           + [((36,), "FADD")])


@pytest.mark.parametrize("n_wei", [16, 8])
def test_k4_counts_each_piece_per_copy(n_wei):
    kern = "_ZN12_GLOBAL__N_124fused_sdvoigt_jvp_kernelEPKi"
    instrs = sass.parse(_gi_listing(kern, K4_ROWS, "fused_xsect_jvp.cu"))[kern]
    c = sass.k4_eval_instructions(instrs, K4_SRC, n_wei)
    # two sd_point copies (six square roots), 5 work instructions each
    assert c["base"] == 5
    # two Weideman copies (their reciprocals), 3 outside the loop each; the
    # loops' 8 work instructions load 4 coefficients; sd_k_grads' region
    # test 2 a copy; four asymptotic copies, 3 each
    assert c["weideman_term"] == 2.0
    assert c["in"] == 2 + 3 + (n_wei - 1) * 2.0
    assert c["out"] == 2 + 3
    # two sd_term copies (two divisions each), 4 each, and the accumulate
    assert c["dir"] == 4 + 1
