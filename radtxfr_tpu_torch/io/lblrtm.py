"""LBLRTM file interop: TAPE12 OD reader/writer, TAPE3 line files and the
TAPE5 deck writer (counterpart of ``radtxfr_tpu/io/lblrtm.py``; host
NumPy, the same bytes; tensors are copied to the host).

The port does not run LBLRTM (its line-by-line engine replaces it),
but users migrating from the reference hold TAPE12 archives and may still
drive LBLRTM elsewhere; these utilities keep that interop:

* :func:`read_tape12` — parses the single-precision little-endian
  Fortran-unformatted OD panel stream (format per
  ``radiative_transfer.py:730-789``: 266 x int32 header, then repeated
  records ``[reclen][v1:f64 v2:f64 dv:f32 n:i4][reclen] [len][payload
  n x f32][len]``), reconstructing the wavenumber axis per panel.
* :func:`write_tape12` — emits the same panel structure (new here; enables
  round-trip tests and producing LBLRTM-compatible OD files from the
  engine).
* :func:`write_tape5` — the single-layer OD-mode punch-card deck with the
  reference's control-record settings (Voigt, LBLF4, user continuum scale
  factors, LBLATM horizontal path; ``radiative_transfer.py:504-727``) and
  its per-species continuum-flag defaulting (``:591-601``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import as_numpy as _host

__all__ = ["read_tape12", "write_tape12", "write_tape5", "read_tape3",
           "write_tape3", "tape3_to_linestore", "HITRAN_MOLECULES"]

#: HITRAN molecule order used by TAPE5 record 3.6 (radiative_transfer.py:539-578)
HITRAN_MOLECULES = (
    "H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2", "NO", "SO2", "NO2",
    "NH3", "HNO3", "OH", "HF", "HCl", "HBr", "HI", "ClO", "OCS", "H2CO",
    "HOCl", "N2", "HCN", "CH3Cl", "H2O2", "C2H2", "C2H6", "PH3", "COF2",
    "SF6", "H2S", "HCOOH", "HO2", "O+", "ClONO2", "NO+", "HOBr", "C2H4",
)


def read_tape12(fname: str = "TAPE12"):
    """Parse an LBLRTM OD TAPE12 file -> (nu, od) float64/float32 arrays."""
    with open(fname, "rb") as f:
        raw = f.read()
    off = 266 * 4
    v1s, v2s, ns, chunks = [], [], [], []
    total = len(raw)
    while off < total:
        reclen = int(np.frombuffer(raw, "<i4", 1, off)[0])
        if reclen != 24:
            raise ValueError(f"unexpected panel-header record length {reclen}")
        off += 4
        v1 = float(np.frombuffer(raw, "<f8", 1, off)[0]); off += 8
        v2 = float(np.frombuffer(raw, "<f8", 1, off)[0]); off += 8
        off += 4  # dv: f32 (axis rebuilt from v1/v2/n, like the reference)
        n = int(np.frombuffer(raw, "<i4", 1, off)[0]); off += 4
        off += 4  # trailing record length
        if n <= 0:
            # real LBLRTM archives terminate with an NLIM = -99 marker panel
            break
        l1 = int(np.frombuffer(raw, "<i4", 1, off)[0]); off += 4
        if l1 != n * 4:
            raise ValueError(f"panel payload length {l1} != 4*{n}")
        chunks.append(np.frombuffer(raw, "<f4", n, off)); off += n * 4
        l2 = int(np.frombuffer(raw, "<i4", 1, off)[0]); off += 4
        if l2 != l1:
            raise ValueError("inconsistent panel record lengths")
        v1s.append(v1); v2s.append(v2); ns.append(n)
    nu = np.concatenate([np.linspace(a, b, n) for a, b, n in zip(v1s, v2s, ns)]) \
        if ns else np.array([])
    od = np.concatenate(chunks) if chunks else np.array([], np.float32)
    return nu, od


def write_tape12(fname: str, nu, od, panel_size: int = 2400) -> None:
    """Write (nu, od) as an LBLRTM-compatible TAPE12 panel stream."""
    nu = _host(nu).astype(np.float64)
    od = _host(od).astype(np.float32)
    with open(fname, "wb") as f:
        np.zeros(266, dtype="<i4").tofile(f)
        for s in range(0, nu.size, panel_size):
            seg_nu = nu[s:s + panel_size]
            seg_od = od[s:s + panel_size]
            n = seg_nu.size
            dv = (seg_nu[-1] - seg_nu[0]) / (n - 1) if n > 1 else 0.0
            np.array([24], "<i4").tofile(f)
            np.array([seg_nu[0], seg_nu[-1]], "<f8").tofile(f)
            np.array([dv], "<f4").tofile(f)
            np.array([n], "<i4").tofile(f)
            np.array([24], "<i4").tofile(f)
            np.array([n * 4], "<i4").tofile(f)
            seg_od.astype("<f4").tofile(f)
            np.array([n * 4], "<i4").tofile(f)


# ---------------------------------------------------------------------------
# TAPE3 (LNFL line file) — the reference engine's 970 MB binary line database
# ---------------------------------------------------------------------------
#
# The reference consumes TAPE3 directly (symlinked into the LBLRTM run dir,
# ``radiative_transfer.py:491``); the repo's copy is an LFS stub, so the
# format here follows the public LNFL/LBLRTM v12.8 LINFIL description
# (same little-endian Fortran-unformatted sequential-record machinery as
# :func:`read_tape12`):
#
# * record 1 — file header: the LNFL user identification block (opaque
#   bytes; preserved verbatim on round trip);
# * then repeated BLOCK PAIRS:
#   - pointer record: ``VMIN f64, VMAX f64, NREC i4, NWDS i4`` (24 bytes);
#     NREC <= 0 terminates the stream;
#   - data record of NREC packed 10-word (40-byte) line entries:
#     ``VNU f64 | S f32 | ALFA f32 | EPP f32 | MOL i4 | HWHMS f32 |
#     TMPALF f32 | PSHIFT f32 | IFLG i4`` — line center, 296 K intensity,
#     air-broadened halfwidth, lower-state energy, packed molecule id,
#     self-broadened halfwidth, temperature exponent, pressure shift,
#     line-coupling flag; ``NWDS == 10 * NREC``.
# * ``MOL`` packs HITRAN molecule and isotopologue as ``100*M + I``
#   (CONVENTION flag 1); ``IFLG != 0`` marks a line whose FOLLOWING entry
#   is not a line but first-order line-coupling data: its 8 f32 payload
#   words are ``Y/G`` pairs at LBLRTM's four coupling temperatures
#   (200, 250, 296, 340 K) and its MOL/IFLG words are ignored
#   (CONVENTION flag 2).
#
# The two CONVENTION points are the only details that cannot be validated
# offline against a real AER TAPE3 (the repo's is an LFS stub); they are
# isolated in ``_T3_ENTRY``/``_unpack_mol`` so a one-line fix adapts the
# reader if a real file disagrees. Everything else (record framing, block
# pairing, field meanings) is the documented LINFIL structure.

#: structured dtype of one packed TAPE3 line entry (10 x 4-byte words)
_T3_ENTRY = np.dtype([
    ("vnu", "<f8"), ("s", "<f4"), ("alfa", "<f4"), ("epp", "<f4"),
    ("mol", "<i4"), ("hwhms", "<f4"), ("tmpalf", "<f4"), ("pshift", "<f4"),
    ("iflg", "<i4"),
])
_T3_COUPLING_TEMPS = (200.0, 250.0, 296.0, 340.0)


def _rec(payload: bytes) -> bytes:
    n = np.array([len(payload)], "<i4").tobytes()
    return n + payload + n


def _read_rec(raw: bytes, off: int):
    n = int(np.frombuffer(raw, "<i4", 1, off)[0])
    start = off + 4
    end = start + n
    if int(np.frombuffer(raw, "<i4", 1, end)[0]) != n:
        raise ValueError(f"inconsistent Fortran record markers at {off}")
    return raw[start:end], end + 4


def _skip_rec(raw: bytes, off: int) -> int:
    """Advance past one Fortran record without copying its payload."""
    n = int(np.frombuffer(raw, "<i4", 1, off)[0])
    end = off + 4 + n
    if int(np.frombuffer(raw, "<i4", 1, end)[0]) != n:
        raise ValueError(f"inconsistent Fortran record markers at {off}")
    return end + 4


def read_tape3(fname: str, nu_min: float | None = None,
               nu_max: float | None = None):
    """Parse an LNFL TAPE3 line file.

    Returns a dict with the line columns (``nu0 sw gamma_air elower mol_id
    local_iso_id gamma_self n_air delta_air iflg``), the raw file
    ``header`` bytes, the block extents ``blocks`` [(vmin, vmax, nrec)],
    and — when coupling entries are present — ``coupling``: a dict with
    ``index`` (positions into the line arrays) and ``yg`` (n, 8) float32
    Y/G pairs at :data:`_T3_COUPLING_TEMPS`.

    ``nu_min``/``nu_max`` band-select at the BLOCK level using the
    pointer records' [VMIN, VMAX] extents: out-of-band blocks are skipped
    without copying (the file is memory-mapped), so a 970 MB-class AER
    TAPE3 costs only its in-band slice of parse time and memory — the
    per-host sharded-parse pattern SURVEY.md SS7 calls for. Widen the
    band by your wing cutoff: a line outside [nu_min, nu_max] still
    contributes absorption within its wing width of the band edge.
    """
    import mmap

    f = open(fname, "rb")
    try:
        raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (ValueError, OSError):
        raw = f.read()                       # empty or special file
    header, off = _read_rec(raw, 0)
    header = bytes(header)
    rows, blocks = [], []
    coup_idx, coup_yg = [], []
    total = len(raw)
    while off < total:
        ptr, off = _read_rec(raw, off)
        if len(ptr) != 24:
            raise ValueError(f"TAPE3 pointer record is {len(ptr)} bytes, "
                             "expected 24 (VMIN f64, VMAX f64, NREC i4, "
                             "NWDS i4)")
        vmin = float(np.frombuffer(ptr, "<f8", 1, 0)[0])
        vmax = float(np.frombuffer(ptr, "<f8", 1, 8)[0])
        nrec = int(np.frombuffer(ptr, "<i4", 1, 16)[0])
        nwds = int(np.frombuffer(ptr, "<i4", 1, 20)[0])
        if nrec <= 0:
            break
        if ((nu_min is not None and vmax < nu_min)
                or (nu_max is not None and vmin > nu_max)):
            off = _skip_rec(raw, off)
            continue
        data, off = _read_rec(raw, off)
        if nwds != 10 * nrec or len(data) != 4 * nwds:
            raise ValueError(
                f"TAPE3 block NWDS {nwds} != 10*NREC ({nrec}) or data "
                f"record {len(data)} bytes != 4*NWDS")
        entries = np.frombuffer(data, _T3_ENTRY, nrec)
        blocks.append((vmin, vmax, nrec))
        flagged = np.nonzero(entries["iflg"] != 0)[0]
        if flagged.size == 0:
            # common case (no line coupling in block): bulk append
            rows.append(entries)
            continue
        # IFLG != 0 -> the next entry carries Y/G coupling data, not a line
        is_coupling = np.zeros(nrec, dtype=bool)
        is_coupling[flagged[flagged + 1 < nrec] + 1] = True
        n_before = sum(r.size for r in rows)
        line_pos = np.cumsum(~is_coupling) - 1 + n_before
        for k in np.nonzero(is_coupling)[0]:
            coup_idx.append(int(line_pos[k]))   # the flagged line before it
            w = np.frombuffer(data[k * 40:k * 40 + 40], "<f4", 10)
            # words 0-7 (the VNU+S+ALFA+EPP+HWHMS+TMPALF+PSHIFT slots
            # reinterpreted) hold the four (Y, G) pairs
            coup_yg.append(np.asarray(w[:8], dtype=np.float32))
        rows.append(entries[~is_coupling])
    if hasattr(raw, "close"):
        raw.close()
    f.close()
    if not rows:
        raise ValueError("TAPE3 contains no line entries in the "
                         "requested band")
    arr = np.concatenate(rows)
    mol = arr["mol"].astype(np.int64)
    out = {
        "nu0": arr["vnu"].astype(np.float64),
        "sw": arr["s"].astype(np.float64),
        "gamma_air": arr["alfa"].astype(np.float64),
        "elower": arr["epp"].astype(np.float64),
        "mol_id": (mol // 100).astype(np.int32),
        "local_iso_id": (mol % 100).astype(np.int32),
        "gamma_self": arr["hwhms"].astype(np.float64),
        "n_air": arr["tmpalf"].astype(np.float64),
        "delta_air": arr["pshift"].astype(np.float64),
        "iflg": arr["iflg"].astype(np.int32),
        "header": header,
        "blocks": blocks,
    }
    if coup_idx:
        out["coupling"] = {"index": np.asarray(coup_idx, dtype=np.int64),
                           "yg": np.stack(coup_yg),
                           "temps": _T3_COUPLING_TEMPS}
    return out


def write_tape3(fname: str, nu0, sw, gamma_air, elower, mol_id,
                local_iso_id, gamma_self, n_air, delta_air,
                coupling=None, header: bytes | None = None,
                block_lines: int = 250) -> None:
    """Write a TAPE3-format line file (synthetic writer for round-trip
    tests and for feeding LBLRTM installations from a :class:`LineStore`).

    ``coupling``: optional dict {line position -> (8,) float32 Y/G pairs
    at :data:`_T3_COUPLING_TEMPS`}; flagged lines get ``IFLG = 1`` and an
    interleaved coupling entry, as LNFL emits for line-coupled species.
    """
    nu0 = _host(nu0).astype(np.float64)
    order = np.argsort(nu0, kind="stable")
    cols = [_host(c)[order] for c in
            (sw, gamma_air, elower, mol_id, local_iso_id, gamma_self,
             n_air, delta_air)]
    nu0 = nu0[order]
    coupling = coupling or {}
    pos_of = {int(o): i for i, o in enumerate(order)}
    coup = {pos_of[int(k)]: np.asarray(v, dtype=np.float32)
            for k, v in coupling.items()}

    entries = []
    for i in range(nu0.size):
        e = np.zeros(1, dtype=_T3_ENTRY)
        e["vnu"] = nu0[i]
        e["s"] = cols[0][i]
        e["alfa"] = cols[1][i]
        e["epp"] = cols[2][i]
        e["mol"] = int(cols[3][i]) * 100 + int(cols[4][i])
        e["hwhms"] = cols[5][i]
        e["tmpalf"] = cols[6][i]
        e["pshift"] = cols[7][i]
        e["iflg"] = 1 if i in coup else 0
        entries.append((e.tobytes(), nu0[i]))
        if i in coup:
            w = np.zeros(10, dtype="<f4")
            w[:8] = coup[i]
            entries.append((w.tobytes(), nu0[i]))

    if header is None:
        header = (b"radtxfr_tpu synthetic TAPE3 (LNFL LINFIL layout)"
                  .ljust(80))
    # block boundaries must not split a (flagged line, coupling) pair:
    # extend a block by one entry when it would end on a flagged line
    bounds = []
    s = 0
    while s < len(entries):
        e = min(s + block_lines, len(entries))
        if e < len(entries):
            tail_iflg = np.frombuffer(entries[e - 1][0], "<i4", 1, 36)[0]
            if tail_iflg:
                e += 1
        bounds.append((s, e))
        s = e

    with open(fname, "wb") as f:
        f.write(_rec(header))
        for s, e in bounds:
            blk = entries[s:e]
            nrec = len(blk)
            vmin, vmax = blk[0][1], blk[-1][1]
            ptr = (np.array([vmin, vmax], "<f8").tobytes()
                   + np.array([nrec, 10 * nrec], "<i4").tobytes())
            f.write(_rec(ptr))
            f.write(_rec(b"".join(b for b, _ in blk)))
        # terminator block (NREC = -99, like TAPE12's NLIM marker)
        ptr = (np.array([0.0, 0.0], "<f8").tobytes()
               + np.array([-99, 0], "<i4").tobytes())
        f.write(_rec(ptr))


def tape3_to_linestore(parsed_or_fname, dtype=torch.float32, nu_min=None,
                       nu_max=None, device=None):
    """Load a TAPE3 file (or :func:`read_tape3` output) into a
    :class:`~radtxfr_tpu_torch.lines.store.LineStore` on ``device`` (None:
    the card) in ``dtype`` (+ optional line-mixing dict).

    Returns ``(store, line_mixing)`` where ``line_mixing`` is a
    ``{'y_air': ...}`` dict built from the 296 K coupling pair when
    coupling entries are present (ready for the engines'
    ``line_mixing=`` parameter), else None. Isotopologues unknown to the
    packaged TIPS registry are dropped with a warning (the reference's
    engine likewise skips what its line file lacks).

    ``nu_min``/``nu_max`` forward to :func:`read_tape3`'s block-level
    band selection (widen by your wing cutoff); ignored when a parsed
    dict is passed.
    """
    from ..lines.store import from_arrays
    from ..lines.tips import iso_row_index

    t3 = (parsed_or_fname if isinstance(parsed_or_fname, dict)
          else read_tape3(parsed_or_fname, nu_min=nu_min, nu_max=nu_max))
    known = iso_row_index()
    ok = np.array([(int(m), int(i)) in known
                   for m, i in zip(t3["mol_id"], t3["local_iso_id"])])
    if not ok.all():
        import warnings

        warnings.warn(f"tape3_to_linestore: dropping {int((~ok).sum())} "
                      "lines with isotopologues outside the TIPS registry")
    sel = np.nonzero(ok)[0]
    store = from_arrays(
        t3["nu0"][sel], t3["sw"][sel], t3["elower"][sel],
        t3["gamma_air"][sel], t3["gamma_self"][sel], t3["n_air"][sel],
        t3["delta_air"][sel], t3["mol_id"][sel], t3["local_iso_id"][sel],
        device=device, dtype=dtype)
    mixing = None
    if "coupling" in t3:
        # y at 296 K (pair index 2); map through the selection + the
        # store's nu0 sort
        y = np.zeros(t3["nu0"].size)
        c = t3["coupling"]
        y[c["index"]] = c["yg"][:, 4]
        y = y[sel][np.argsort(t3["nu0"][sel], kind="stable")]
        mixing = {"y_air": y}
    return store, mixing


def default_continuum_factors(mf: np.ndarray, cf=None,
                              override: bool = False) -> np.ndarray:
    """Per-species continuum scale-factor defaulting
    (radiative_transfer.py:591-601): enable H2O self+foreign, CO2, O3, O2,
    N2 continua only for species present in the mixture."""
    cf = np.zeros(7) if cf is None else _host(cf).astype(float)
    if not override:
        if mf[0] > 0:
            cf[0] = cf[1] = 1
        if mf[1] > 0:
            cf[2] = 1
        if mf[2] > 0:
            cf[3] = 1
        if mf[6] > 0:
            cf[4] = 1
        if mf[21] > 0:
            cf[5] = 1
    return cf


def write_tape5(
    fname: str,
    v1: float,
    v2: float,
    T: float = 296.0,
    P_pa: float = 101325.0,
    PL_km: float = 1.0,
    mf_ppmv=None,
    mf_ids=None,
    dvout: float = 0.0025,
    continuum_factors=None,
    continuum_override: bool = False,
    description: str = "TAPE5 single-layer OD (radtxfr_tpu interop)",
) -> None:
    """Write a single-layer OD-mode TAPE5 deck (LBLRTM punch-card format).

    Control settings match the reference's OD configuration
    (``radiative_transfer.py:619-656``): Voigt (HI=1), line-by-line F4,
    user-supplied continuum scale factors (CN=6), OD-only (EM=0), LBLATM
    user-defined single homogeneous layer.
    """
    mf = np.zeros(len(HITRAN_MOLECULES))
    if mf_ids is not None and mf_ppmv is not None:
        for mid, val in zip(_host(mf_ids).ravel(),
                            _host(mf_ppmv).ravel()):
            mf[int(mid) - 1] = val
    cf = default_continuum_factors(mf, continuum_factors, continuum_override)

    cards = [description]
    cards.append("         1         2         3         4         5"
                 "         6         7         8         9         0")
    cards.append("123456789 " * 11)
    cards.append("$ None")
    # Record 1.2: control flags for a single-layer OD run
    cards.append(
        " HI=1 F4=1 CN=6 AE=0 EM=0 SC=0 FI=0 PL=0 TS=0 AM=1 MG=0 LA=0 MS=1"
        " XS=0   0   0"
    )
    # Record 1.2a: continuum scale factors
    cards.append((len(cf) * "{:8.6f} ").format(*cf).rstrip())
    # Record 1.3: spectral range
    rec = 8 * "{:10.3f}" + "    {:1d}     {:10.3E}   {:2d}"
    cards.append(rec.format(v1, v2, 4, 0, 0.04, 36, 0, 0, 0, dvout, 0))
    # Record 3.1: LBLATM, user model, horizontal path
    cards.append((5 * "{:5d}").format(0, 1, 0, 0, 0, len(mf)))
    # Record 3.2: path length
    cards.append("{:10.3E}                    {:10.3E}".format(0, PL_km))
    # Record 3.4
    cards.append("    1 (1 homogeneous layer)")
    # Record 3.5: thermodynamic state (atm, degC)
    cards.append(
        "{0:10.3E}{1:10.3E}{2:10.3E}     BB L {3}".format(
            0, P_pa / 101325.0, T - 273.15, "A" * 39
        )
    )
    # Record 3.6: species columns, 8 per card
    for s in range(0, len(mf), 8):
        row = mf[s:s + 8]
        cards.append((len(row) * "{:15.8E}").format(*row))
    cards.append(r"%%")
    with open(fname, "w") as f:
        f.write("\n".join(cards))
