"""The built kernels' machine code (SASS), read back with its source lines.

:func:`disassemble` runs ``cuobjdump -xelf all`` and ``nvdisasm
--print-line-info`` (the libraries are built with ``-lineinfo``) over a
built library; :func:`parse` splits the listing into kernels, each a list
of instructions with the innermost source line that produced it. The
counts of the issue-slot bounds are taken from these listings.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import tempfile

from .. import _build

__all__ = ["disassemble", "parse", "Instr"]

_FUNC = re.compile(r"^\s*\.text\.(\S+?):?\s*$|^\s*(_Z\w+):\s*$")
_LINE = re.compile(r'//##\s*File\s*"([^"]*)",\s*line\s*(\d+)')
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


class Instr(tuple):
    """(file basename, source line, opcode with modifiers, predicated)."""

    __slots__ = ()

    def __new__(cls, file, line, op, pred):
        return tuple.__new__(cls, (file, line, op, pred))

    file = property(lambda s: s[0])
    line = property(lambda s: s[1])
    op = property(lambda s: s[2])
    pred = property(lambda s: s[3])


def disassemble(lib_path: str) -> str:
    """The SASS listing of every kernel in the library, with line info."""
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([_build.tool("cuobjdump"), "-xelf", "all",
                        os.path.abspath(lib_path)], cwd=tmp, check=True,
                       capture_output=True)
        parts = []
        for cubin in sorted(glob.glob(os.path.join(tmp, "*.cubin"))):
            parts.append(subprocess.run(
                [_build.tool("nvdisasm"), "--print-line-info",
                 "--print-code", cubin], check=True, capture_output=True,
                text=True).stdout)
    return "\n".join(parts)


def parse(listing: str) -> dict:
    """{kernel (mangled name): [Instr, ...]} in listing order; each
    instruction carries the innermost source location printed before it.
    Code that runs only off the common path is left out: the subroutines
    after the kernel's body (the IEEE division's and reciprocal's slow
    paths, from their ``$__internal`` label on) and each call site's glue
    (the instructions between the predicated branch that skips it and the
    next label)."""
    out = {}
    cur = None
    loc = ("", 0)
    glue = []   # this block's instructions since its last predicated BRA
    for raw in listing.splitlines():
        m = _FUNC.match(raw)
        if m:
            cur = out.setdefault(m.group(1) or m.group(2), [])
            loc = ("", 0)
            glue = []
            continue
        if raw.lstrip().startswith("$__internal"):
            cur = None                       # a subroutine: off the path
            continue
        if raw.rstrip().endswith(":"):       # a label ends a call's glue
            glue = []
            continue
        m = _LINE.search(raw)
        if m:
            loc = (os.path.basename(m.group(1)), int(m.group(2)))
            continue
        m = _INSTR.search(raw)
        if not m or cur is None:
            continue
        ins = Instr(loc[0], loc[1], m.group(2), bool(m.group(1)))
        if ins.op.startswith("BRA") and ins.pred:
            glue = []
            cur.append(ins)
            glue = [len(cur)]                # instructions after it
            continue
        cur.append(ins)
        if ins.op.startswith("CALL") and glue:
            del cur[glue[0]:]                # the glue up to the call
            glue = [len(cur)]
        elif glue and len(cur) - glue[0] > 8:
            glue = []                        # too long for glue
    return out


#: opcodes of the work itself: floating-point arithmetic, compares and
#: selects, the special-function units and operand loads (not integer
#: indexing, moves, branches, barriers or spills)
WORK = ("F", "MUFU", "LDS", "LDG")


def _brace_range(rows, i: int) -> range:
    """Source lines (1-based) from row ``i`` (0-based) to the row closing
    the brace it opens."""
    depth, opened = 0, False
    for j in range(i, len(rows)):
        depth += rows[j].count("{") - rows[j].count("}")
        opened |= "{" in rows[j]
        if opened and depth <= 0:
            return range(i + 1, j + 2)
    raise ValueError(f"no closing brace after {rows[i]!r}")


def _lines(src: str, start: str) -> range:
    """Source lines (1-based) of the first definition whose line contains
    ``start``, to the line closing its brace."""
    rows = src.splitlines()
    return _brace_range(rows, next(n for n, r in enumerate(rows)
                                   if start in r))


def _loop(src: str, within: range) -> range:
    """Source lines of the first ``for`` loop inside the lines ``within``."""
    rows = src.splitlines()
    return _brace_range(rows, next(n - 1 for n in within
                                   if rows[n - 1].lstrip().startswith("for (")))


def _count(instrs, lines, op=None):
    return sum(1 for i in instrs
               if i.line in lines and (op is None or i.op.startswith(op)))


def _work(instrs, lines):
    return sum(1 for i in instrs if i.line in lines and i.op.startswith(WORK))


def _fn(src: str, ret: str, name: str) -> range:
    return _lines(src, f"__device__ __forceinline__ {ret} {name}(")


def kernel(listing: dict, pattern: str) -> list:
    """The instructions of the one kernel whose mangled name matches."""
    hits = [v for k, v in listing.items() if re.search(pattern, k)]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} kernels match {pattern!r}")
    return hits[0]


def k1_eval_instructions(instrs, src: str, mode: int, n_wei: int) -> dict:
    """Issue slots one K1 Voigt-mode evaluation needs (``mode``: 0 asym,
    1 core, 2 mix, 3 full), from its kernel's SASS: the :data:`WORK`
    instructions of the line shape (``voigt_value`` and what it calls)
    inside (``in``) and outside (``out``) hum1_wei's |x| + y < 15, with
    Weideman's term taken ``n_wei - 1`` times, plus the one FFMA that
    scales and adds it (none where ``core`` adds nothing). The kernel's
    window tests, indexing and loop code are not counted. The evaluation is
    unrolled and the compiler may copy it again; its copies are counted by
    the one reciprocal (MUFU.RCP) of the asymptotic form each holds
    (``asym_re_w``; ``far_kl`` for mix, ``far_re_w`` for full), and
    Weideman's terms by the coefficients its loop loads (LDS.64 two)."""
    fn = {"value": _fn(src, "float", "voigt_value"),
          "asym": _fn(src, "float", "asym_re_w"),
          "wei": _fn(src, "void", "weideman_w"),
          "far_re": _fn(src, "float", "far_re_w"),
          "far_kl": _fn(src, "void", "far_kl")}
    marker = {0: "asym", 1: "asym", 2: "far_kl", 3: "far_re"}[mode]
    copies = max(_count(instrs, fn[marker], "MUFU.RCP"), 1)
    c = {k: _work(instrs, v) / copies for k, v in fn.items()}
    loop = _loop(src, fn["wei"])
    terms = sum({"LDS.64": 2, "LDS.128": 4}.get(i.op, 1) for i in instrs
                if i.line in loop and i.op.startswith("LDS"))
    per_term = _work(instrs, loop) / max(terms, 1)
    weideman = (c["wei"] - _work(instrs, loop) / copies
                + (n_wei - 1) * per_term)
    far = {0: c["asym"], 1: 0.0, 2: c["far_kl"], 3: c["far_re"]}[mode]
    core = {0: c["asym"], 1: weideman + c["asym"], 2: weideman,
            3: weideman}[mode]
    return {"in": c["value"] + core + 1, "out": c["value"] + far
            + (mode != 1), "weideman_term": per_term}


def ld_eval_instructions(instrs, src: str, mode: int) -> dict:
    """Issue slots one Lorentz (``mode`` 7) or Doppler (8) evaluation
    needs, from its kernel's SASS: the :data:`WORK` instructions of
    ``ld_value`` per copy (counted by the one MUFU.RCP of Lorentz's
    reciprocal or MUFU.EX2 of Doppler's ``expf`` each holds), plus the one
    FFMA that scales and adds it; the same inside and outside the window's
    core (``in``, ``out``)."""
    fn = _fn(src, "float", "ld_value")
    marker = {7: "MUFU.RCP", 8: "MUFU.EX2"}[mode]
    per = _work(instrs, fn) / max(_count(instrs, fn, marker), 1) + 1
    return {"in": per, "out": per}


def k3_eval_instructions(instrs, src: str, n_wei: int) -> dict:
    """Issue slots a K3 evaluation needs, from its kernel's SASS: per live
    (slot, layer, point) the :data:`WORK` instructions of ``tangent_term``
    but its return line (the offset x, the region test, K + x Kx + y Ky)
    with the (K, Kx, Ky) it takes, Weideman's inside |x| + y < 15 (``in``,
    its term taken ``n_wei - 1`` times) or the asymptotic form's outside
    (``out``); per live direction of it (``dir``) the return line, which
    combines the direction's four coefficients, and the FADD that adds it.
    The kernel's window tests, indexing and loop code are not counted.
    ``tangent_term``'s copies are counted by the one MUFU.RCP of
    ``asym_k_grads`` each holds, Weideman's by its own one."""
    fn = {"term": _fn(src, "float", "tangent_term"),
          "asym": _fn(src, "KGrads", "asym_k_grads"),
          "wei": _fn(src, "KGrads", "weideman_k_grads")}
    rows = src.splitlines()
    ret = [n for n in fn["term"] if rows[n - 1].lstrip().startswith("return")]
    copies = max(_count(instrs, fn["asym"], "MUFU.RCP"), 1)
    wei_copies = max(_count(instrs, fn["wei"], "MUFU.RCP"), 1)
    loop = _loop(src, fn["wei"])
    terms = sum({"LDS.64": 2, "LDS.128": 4}.get(i.op, 1) for i in instrs
                if i.line in loop and i.op.startswith("LDS"))
    per_term = _work(instrs, loop) / max(terms, 1)
    weideman = ((_work(instrs, fn["wei"]) - _work(instrs, loop)) / wei_copies
                + (n_wei - 1) * per_term)
    base = (_work(instrs, fn["term"]) - _work(instrs, ret)) / copies
    return {"in": base + weideman,
            "out": base + _work(instrs, fn["asym"]) / copies,
            "dir": _work(instrs, ret) / copies + 1,
            "weideman_term": per_term}


def k2_instructions(instrs, src: str, n_mu: int, n_angles: int,
                    planck: bool) -> dict:
    """Issue slots per column and layer that K2's work needs, from its
    kernel's SASS: the layer's od load, the source (``planck``: its expm1
    and divide, per the divide's one MUFU.RCP; else its load), and one
    carry step (``carry_step``: the exponent's FMUL, the MUFU.EX2, the
    carry's FADD and FFMA, per its one MUFU.EX2) per slant secant, with the
    running OD's add, and per downwelling angle; :data:`WORK` instructions
    only. The kernel's snapshot, staging and loop code and the angle
    chunk's unused slots are not counted."""
    src_l = _lines(src, "auto source = [&](int l) {")
    step = [*_fn(src, "float", "carry_step"), *_fn(src, "float", "ex2_sfu")]
    mark = "MUFU.RCP" if planck else "LDG"
    per = {"source": _work(instrs, src_l) / max(_count(instrs, src_l, mark),
                                                1),
           "step": _work(instrs, step) / max(_count(instrs, step,
                                                    "MUFU.EX2"), 1)}
    per["total"] = (1 + per["source"] + n_mu * (per["step"] + 1)
                    + n_angles * per["step"])
    return per
