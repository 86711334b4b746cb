"""The built kernels' machine code (SASS), read back with its source lines.

:func:`disassemble` runs ``cuobjdump -xelf all`` and ``nvdisasm
--print-line-info`` (the libraries are built with ``-lineinfo``) over a
built library, or with ``inline`` ``--print-line-info-inline``, which
prints before an instruction the whole chain of source lines it was
inlined through, innermost first; :func:`parse` splits the listing into
kernels, each a list of instructions with the innermost source line that
produced it (and that chain). The counts of the issue-slot bounds are
taken from these listings.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import tempfile

from .. import _build

__all__ = ["disassemble", "parse", "Instr", "ChainInstr"]

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


class ChainInstr(Instr):
    """An :class:`Instr` (equal to its four fields) that also carries
    ``chain``: the (file basename, line) frames it was inlined through,
    innermost first (one frame where the listing prints no inlining)."""

    def __new__(cls, file, line, op, pred, chain):
        obj = Instr.__new__(cls, file, line, op, pred)
        obj.chain = chain
        return obj


def disassemble(lib_path: str, inline: bool = False) -> str:
    """The SASS listing of every kernel in the library, with line info
    (``inline``: with each instruction's chain of inlined call sites)."""
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([_build.tool("cuobjdump"), "-xelf", "all",
                        os.path.abspath(lib_path)], cwd=tmp, check=True,
                       capture_output=True)
        parts = []
        for cubin in sorted(glob.glob(os.path.join(tmp, "*.cubin"))):
            parts.append(subprocess.run(
                [_build.tool("nvdisasm"), "--print-line-info-inline"
                 if inline else "--print-line-info", "--print-code", cubin],
                check=True, capture_output=True, text=True).stdout)
    return "\n".join(parts)


def parse(listing: str) -> dict:
    """{kernel (mangled name): [ChainInstr, ...]} in listing order; each
    instruction carries the innermost source location printed before it,
    and the chain of locations printed with it. Code that runs only off the
    common path is left out: the subroutines after the kernel's body (the
    IEEE division's and reciprocal's slow paths, from their ``$__internal``
    label on) and each call site's glue (the instructions between the
    predicated branch that skips it and the next label)."""
    out = {}
    cur = None
    chain = (("", 0),)
    frames = []  # the location lines since the last instruction
    glue = []    # this block's instructions since its last predicated BRA
    for raw in listing.splitlines():
        m = _FUNC.match(raw)
        if m:
            cur = out.setdefault(m.group(1) or m.group(2), [])
            chain, frames, glue = (("", 0),), [], []
            continue
        if raw.lstrip().startswith("$__internal"):
            cur = None                       # a subroutine: off the path
            continue
        if raw.rstrip().endswith(":"):       # a label ends a call's glue
            glue = []
            continue
        m = _LINE.search(raw)
        if m:
            frames.append((os.path.basename(m.group(1)), int(m.group(2))))
            continue
        m = _INSTR.search(raw)
        if not m or cur is None:
            continue
        if frames:
            chain, frames = tuple(frames), []
        ins = ChainInstr(chain[0][0], chain[0][1], m.group(2),
                         bool(m.group(1)), chain)
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


def _fns(src: str, ret: str, name: str) -> range:
    """Source lines of every definition (overload) of ``name``."""
    rows = src.splitlines()
    head = f"__device__ __forceinline__ {ret} {name}("
    lines = set()
    for n, r in enumerate(rows):
        if head in r:
            lines.update(_brace_range(rows, n))
    return sorted(lines)


def _owned(instrs, file: str, ranges: dict):
    """(key, line, instruction) for each instruction inlined through one of
    the functions of ``file`` whose source lines ``ranges`` ({key: lines})
    holds: the innermost such function of its chain and its line there."""
    for i in instrs:
        for f, ln in i.chain:
            if f != file:
                continue
            k = next((k for k, r in ranges.items() if ln in r), None)
            if k is not None:
                yield k, ln, i
                break


def _in_lines(i, file: str, lines) -> bool:
    """Whether an instruction was inlined through one of ``lines``."""
    return any(f == file and n in lines for f, n in i.chain)


def _coefficients(i) -> int:
    """The Weideman coefficients a loop's load instruction brings."""
    return {"LDS.64": 2, "LDS.128": 4}.get(i.op, 1) if i.op.startswith(
        "LDS") else 0


def ht_eval_instructions(instrs, src: str, n_wei: int) -> dict:
    """Issue slots the pieces of a K5 or K6 evaluation need, from its
    kernel's SASS read with inlining (``disassemble(inline=True)``): each
    :data:`WORK` instruction belongs to the innermost function of
    ``fused_ht.cu`` it was inlined through among the profile's own
    (``pcqsdhc``, ``ht_part1``, ``ht_b1_big``, ``ht_b1_small``,
    ``ht_part234``, ``ht_part4``, ``ht_ls``, ``voigt_w``, ``w_wei``,
    ``w_asym``, ``cpf3``, ``ht_pair``, ``ht_pair234``, ``accumulate``).
    Per evaluation: ``part4`` (pcqsdhc's prelude, X and sqrt(X + Y), PART4
    but its w(Z) and its CPF3 test, the final LS), ``cpf3_test`` (|Z1|,
    |Z2| and the test, skipped in spans outside the Weideman range),
    ``part1`` and ``part1_big`` (its |Z1| <= 4e3 or > 4e3 form); per CPF
    point ``w_wei`` (voigt_w's region test and the Weideman series, its
    term taken ``n_wei - 1`` times) or ``w_asym``; per kept pair ``pair4``
    and ``pair1`` (ht_pair); ``acc`` the accumulate. Copies of voigt_w's
    forms are counted by their reciprocals (MUFU.RCP: two in w_wei, one in
    w_asym); every other function has one call site, counted once. The
    Weideman loop's terms are counted by the coefficients it loads (LDS,
    LDS.64 two). CPF3 is not counted (the bounds charge it as Weideman)."""
    names = {"pcq": ("T", "pcqsdhc"), "p1": ("void", "ht_part1"),
             "b1big": ("Cx<T>", "ht_b1_big"),
             "b1small": ("Cx<T>", "ht_b1_small"),
             "p234": ("void", "ht_part234"), "p4": ("void", "ht_part4"),
             "ls": ("T", "ht_ls"), "vw": ("Cx<T>", "voigt_w"),
             "wei": ("Cx<T>", "w_wei"), "asym": ("Cx<T>", "w_asym"),
             "cpf3": ("Cx<T>", "cpf3"), "pair": ("HtPair<T>", "ht_pair"),
             "pair234": ("void", "ht_pair234"),
             "acc": ("float", "accumulate")}
    ranges = {k: set(_fns(src, *v)) for k, v in names.items()}
    rows = src.splitlines()
    p4 = sorted(ranges["p4"])
    test = set(_brace_range(rows, next(
        n - 1 for n in p4 if rows[n - 1].lstrip().startswith("if (!far)"))))
    loop = set(_loop(src, sorted(ranges["wei"])))

    work = dict.fromkeys(ranges, 0)
    work["test"] = work["loop"] = 0
    rcp = {"wei": 0, "asym": 0}
    terms = 0
    for k, ln, i in _owned(instrs, "fused_ht.cu", ranges):
        if i.op.startswith("MUFU.RCP") and k in rcp:
            rcp[k] += 1
        if not i.op.startswith(WORK):
            continue
        work[k] += 1
        if k == "p4" and ln in test:
            work["test"] += 1
        if k == "wei" and _in_lines(i, "fused_ht.cu", loop):
            work["loop"] += 1
            terms += _coefficients(i)
    n_wei_copies = max(rcp["wei"] / 2, 1)
    n_asym_copies = max(rcp["asym"], 1)
    per_term = work["loop"] / max(terms, 1)
    region_test = work["vw"] / n_asym_copies
    base = work["pcq"] + work["ls"]
    return {"part4": base + work["p234"] + work["p4"] - work["test"],
            "cpf3_test": work["test"],
            "part1": base + work["p1"] + work["b1small"],
            "part1_big": base + work["p1"] + work["b1big"],
            "w_wei": region_test + (work["wei"] - work["loop"]) / n_wei_copies
            + (n_wei - 1) * per_term,
            "w_asym": region_test + work["asym"] / n_asym_copies,
            "pair4": work["pair"] + work["pair234"], "pair1": work["pair"],
            "acc": work["acc"], "weideman_term": per_term}


def k4_eval_instructions(instrs, src: str, n_wei: int) -> dict:
    """Issue slots the pieces of a K4 evaluation need, from its kernel's
    SASS read with inlining (``disassemble(inline=True)``): each :data:`WORK`
    instruction belongs to the innermost of K4's functions in
    ``fused_xsect_jvp.cu`` it was inlined through (``sd_point``,
    ``sd_k_grads``, ``sd_k_wei``, ``sd_k_asym``, ``sd_term``). Per
    evaluation ``base`` (sd_point: dnu, Im X, S and the denominator); per
    CPF point ``in`` (sd_k_grads' region test and the Weideman series, its
    term taken ``n_wei - 1`` times) or ``out`` (the region test and the
    asymptotic form); per live direction ``dir`` (sd_term and the FADD
    that accumulates it). The kernel's window tests, staging and loop code
    are not counted. Copies are counted by their special-function
    instructions: sd_point's three square roots (MUFU.RSQ), sd_term's two
    divisions, sd_k_wei's and sd_k_asym's one each (MUFU.RCP); sd_k_grads'
    by sd_k_wei's. The Weideman loop's terms are counted by the
    coefficients it loads (LDS, LDS.64 two)."""
    file = "fused_xsect_jvp.cu"
    names = {"point": ("SdPoint", "sd_point"), "kx": ("KGrads", "sd_k_grads"),
             "wei": ("KGrads", "sd_k_wei"), "asym": ("KGrads", "sd_k_asym"),
             "term": ("float", "sd_term")}
    marker = {"point": ("MUFU.RSQ", 3), "term": ("MUFU.RCP", 2),
              "wei": ("MUFU.RCP", 1), "asym": ("MUFU.RCP", 1)}
    ranges = {k: set(_fns(src, *v)) for k, v in names.items()}
    loop = set(_loop(src, sorted(ranges["wei"])))
    work = dict.fromkeys(ranges, 0)
    marks = dict.fromkeys(marker, 0)
    loop_work = terms = 0
    for k, _, i in _owned(instrs, file, ranges):
        if k in marker and i.op.startswith(marker[k][0]):
            marks[k] += 1
        if not i.op.startswith(WORK):
            continue
        work[k] += 1
        if k == "wei" and _in_lines(i, file, loop):
            loop_work += 1
            terms += _coefficients(i)
    copies = {k: max(marks[k] / n, 1) for k, (_, n) in marker.items()}
    per_term = loop_work / max(terms, 1)
    test = work["kx"] / copies["wei"]
    return {"base": work["point"] / copies["point"],
            "in": test + (work["wei"] - loop_work) / copies["wei"]
            + (n_wei - 1) * per_term,
            "out": test + work["asym"] / copies["asym"],
            "dir": work["term"] / copies["term"] + 1,
            "weideman_term": per_term}
