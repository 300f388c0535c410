"""Stage-product file writers for mechanical diffing against the reference.

The reference pipeline communicates through product files; this
framework keeps everything in memory but can emit the same products on
request so that stage-level diffing against a compiled reference (or
archived runs) stays mechanical:

* angle tables (``SOS_UsedAngles.txt`` layout, ``src/SOS_ANGLES.F:168-194``
  and formats ``:634-648``) — ``-ANG.Rad.ResFile`` / ``-ANG.Aer.ResFile``;
* aerosol expansion (``Aerosols.txt``, formats
  ``src/SOS_AEROSOLS.F:3048-3053`` written at ``:2868-2890``) —
  ``-AER.ResFile``;
* the binary Fourier-record product (``SOS_Result.bin``: one Fortran
  unformatted record per Fourier order IS holding
  ``(Q(-N..N), U(-N..N), I(-N..N))``, ``src/SOS_OS.F:1571-1575``) —
  ``-SOS.ResBin``;
* user-angle-filtered radiance files (rows with ``IND_ANGOUT == 1`` only,
  ``src/SOS_ABS_MAIN.F:2338-2366``) — ``-SOS.ResFileUp.UserAng`` /
  ``-SOS.ResFileDown.UserAng``.
"""

from __future__ import annotations

import struct

import numpy as np


def _d21(x: float) -> str:
    """Fortran D21.14 field (exponent letter D)."""
    s = "%21.14E" % x
    return s.replace("E", "D")


def write_angles_file(path: str, mu, w, kind: str, os_nb: int,
                      n_gauss: int, userfile: str = "NO_USER_ANGLES",
                      thetas_deg: float | None = None,
                      imus: int | None = None, os_ns: int | None = None,
                      os_nm: int | None = None,
                      is_user=None) -> None:
    """Angle product (``FICRES_MIE``/``FICRES_LUM``), formats
    ``src/SOS_ANGLES.F:634-648``."""
    mu = np.asarray(mu)
    w = np.asarray(w)
    with open(path, "w") as f:
        f.write("NB_TOTAL_ANGLES :%4d\n" % mu.shape[0])
        f.write("NB_GAUSS_ANGLES :%4d\n" % n_gauss)
        f.write("ANGLES_USERFILE :%s\n" % userfile)
        if kind == "LUM":
            f.write("SOLAR ZENITH ANGLE :%7.3f\n" % thetas_deg)
            f.write("INTERNAL_IMUS :%4d\n" % (imus + 1))
        f.write("INTERNAL_OS_NB :%4d\n" % os_nb)
        if kind == "LUM":
            f.write("INTERNAL_OS_NS :%4d\n" % os_ns)
            f.write("INTERNAL_OS_NM :%4d\n" % os_nm)
        f.write("INDEX   COS_ANGLE            WEIGHT\n")
        for j in range(mu.shape[0]):
            row = "%4d %s%s" % (j + 1, _d21(mu[j]), _d21(w[j]))
            if kind == "LUM":
                row += " %4d" % (int(is_user[j]) if is_user is not None
                                 else 0)
            f.write(row + "\n")


def write_aerosols_file(path: str, expansion, mean_ext=None,
                        mean_sca=None, asym=None) -> None:
    """``Aerosols.txt`` (written ``src/SOS_AEROSOLS.F:2868-2890``, formats
    ``:3048-3053``)."""
    e = expansion
    os_nb = len(np.asarray(e.beta)) - 1
    with open(path, "w") as f:
        f.write("---------------------------------\n")
        f.write("EXTINCTION CROSS SECTION (mic^2)     :%13.5E\n"
                % (mean_ext if mean_ext is not None else e.sigma_ext))
        f.write("SCATTERING CROSS SECTION (mic^2)     :%13.5E\n"
                % (mean_sca if mean_sca is not None else e.sigma_sca))
        f.write("ASYMMETRY FACTOR (no truncation)     :%13.5E\n"
                % (asym if asym is not None else 0.0))
        f.write("TRUNCATION COEFFICIENT               :%9.5f\n"
                % e.coef_tronca)
        f.write("SINGLE SCATTERING ALBEDO (truncation):%9.5f\n"
                % e.piz_tronc)
        f.write("---------------------------------\n")
        f.write("PHASE MATRIX COEFFICIENTS FOR K=0 TO%4d\n" % os_nb)
        f.write("ALPHA(K)        BETA11(K)       GAMMA12(K)      "
                "ZETA(K)\n")
        for k in range(os_nb + 1):
            f.write("%15.8E %15.8E %15.8E %15.8E\n"
                    % (e.alpha[k], e.beta[k], e.gamma[k], e.zeta[k]))


def write_fourier_bin(path: str, records_signed: np.ndarray) -> None:
    """Binary Fourier-record product (``src/SOS_OS.F:1571-1575``).

    ``records_signed``: (S, 3, D) aggregated Stokes records on the signed
    direction axis (Stokes order I, Q, U — ours), D = 2*NBMU+1.  One
    Fortran unformatted sequential record per order: 4-byte length marker,
    ``(Q, U, I)`` each over the full signed range, 4-byte marker.  Orders
    past the last non-zero record (the Fourier exit) are not written,
    matching the reference file which only holds computed orders.
    """
    recs = np.asarray(records_signed, dtype=np.float64)
    nz = np.nonzero(np.any(recs != 0.0, axis=(1, 2)))[0]
    n_write = (int(nz[-1]) + 1) if nz.size else 1
    with open(path, "wb") as f:
        for s in range(n_write):
            payload = np.concatenate(
                [recs[s, 1], recs[s, 2], recs[s, 0]]).tobytes()
            marker = struct.pack("<i", len(payload))
            f.write(marker + payload + marker)


def read_fourier_bin(path: str, d: int) -> np.ndarray:
    """Inverse of :func:`write_fourier_bin` -> (S, 3, D) in (I, Q, U)."""
    out = []
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            (ln,) = struct.unpack("<i", head)
            payload = np.frombuffer(f.read(ln), dtype=np.float64)
            f.read(4)
            q, u, i = payload.reshape(3, d)
            out.append(np.stack([i, q, u]))
    return np.stack(out)


def write_user_angle_radiance_file(path: str, res, updown: int,
                                   itrphi: int, zalt) -> None:
    """User-angle-filtered ``SOS_Up/Down`` variant
    (``-SOS.ResFileUp.UserAng``, rows with ``IND_ANGOUT == 1`` only,
    ``src/SOS_ABS_MAIN.F:2338-2366``)."""
    from .api import _radiance_header

    tabs = res.up if updown == 1 else res.down
    theta = res.theta
    keep = np.asarray(res.grid.is_user, dtype=bool)
    with open(path, "w") as f:
        f.write(_radiance_header(itrphi, updown, zalt))
        if itrphi == 1:
            n = theta.shape[0]
            for row, sgn, order in ((0, -1.0, range(n - 1, -1, -1)),
                                    (1, 1.0, range(n))):
                for j in order:
                    if not keep[j]:
                        continue
                    f.write("  %7.2f %7.2f  %13.6e  %13.6e  %13.6e  "
                            "%7.2f %7.2f %13.6e\n"
                            % (sgn * theta[j], tabs["sca"][row, j],
                               tabs["i"][row, j], tabs["q"][row, j],
                               tabs["u"][row, j], tabs["pol_ang"][row, j],
                               tabs["pol_rate"][row, j],
                               tabs["l_pol"][row, j]))
        else:
            for ip, phid in enumerate(res.phi):
                for j in range(theta.shape[0]):
                    if not keep[j]:
                        continue
                    f.write(" %7.2f %7.2f %7.2f  %13.6e  %13.6e  %13.6e  "
                            "%7.2f %7.2f %13.6e\n"
                            % (phid, theta[j], tabs["sca"][ip, j],
                               tabs["i"][ip, j], tabs["q"][ip, j],
                               tabs["u"][ip, j], tabs["pol_ang"][ip, j],
                               tabs["pol_rate"][ip, j],
                               tabs["l_pol"][ip, j]))


def read_aerosols_file(path: str):
    """Parse an ``Aerosols.txt``-format file back into expansion data.

    Inverse of :func:`write_aerosols_file`; the reference consumes such a
    file via ``-AER.UserFile`` in place of running the aerosol chain
    (``src/SOS_PROC.F:2883-2933``), reading it back in ``SOS_PREPA_OS``.
    The true single-scattering albedo is reconstructed from the stored
    truncated albedo like ``src/SOS_PREPA_OS.F:700``:
    ``PIZ = PIZTR / (1 + 0.5 A (PIZTR - 1))``.

    Returns a dict with keys matching :class:`aerosols.AerosolExpansion`.
    """
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]

    def field(tag):
        for ln in lines:
            if ln.startswith(tag):
                return float(ln.split(":")[-1].replace("D", "E"))
        raise ValueError(f"{path}: missing '{tag}' header line")

    sigma_ext = field("EXTINCTION CROSS SECTION")
    sigma_sca = field("SCATTERING CROSS SECTION")
    coef_tronca = field("TRUNCATION COEFFICIENT")
    piz_tronc = field("SINGLE SCATTERING ALBEDO (truncation)")

    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("ALPHA(K)")) + 1
    rows = [[float(v.replace("D", "E")) for v in ln.split()]
            for ln in lines[start:] if ln.strip()]
    arr = np.asarray(rows, dtype=np.float64)
    if arr.shape[1] != 4:
        raise ValueError(f"{path}: expected 4 coefficient columns, "
                         f"got {arr.shape[1]}")
    a = coef_tronca
    piz = piz_tronc / (1.0 + 0.5 * a * (piz_tronc - 1.0))
    return dict(alpha=arr[:, 0], beta=arr[:, 1], gamma=arr[:, 2],
                zeta=arr[:, 3], coef_tronca=a, piz=piz,
                piz_tronc=piz_tronc, sigma_ext=sigma_ext,
                sigma_sca=sigma_sca)


def write_surface_bin(path: str, rmat: np.ndarray) -> None:
    """Surface reflection-matrix file in the reference's binary layout.

    One Fortran sequential-unformatted record per Fourier order IS holding
    the nine REAL (N, N) matrices R11..R33 in row order
    (``src/SOS_OS.F:239-255``, read ``:916-925``; written by
    ``SOS_MISE_FORMAT``, ``src/SOS_SURFACE.F:2307``).  Element order inside
    each matrix is Fortran ``((R(I,J), I), J)`` with I the incidence index
    mapping to ``rmat[s, x, y, j, k]``'s ``j`` axis.
    """
    rmat = np.asarray(rmat)
    n_s, _, _, n, _ = rmat.shape
    with open(path, "wb") as f:
        for s in range(n_s):
            payload = b"".join(
                np.asarray(rmat[s, x, y], dtype="<f4").tobytes(order="F")
                for x in range(3) for y in range(3))
            marker = struct.pack("<i", len(payload))
            f.write(marker + payload + marker)


def read_surface_bin(path: str, n: int) -> np.ndarray:
    """Inverse of :func:`write_surface_bin`: returns (S, 3, 3, N, N)."""
    records = []
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            nbytes = struct.unpack("<i", head)[0]
            payload = f.read(nbytes)
            tail = f.read(4)
            if struct.unpack("<i", tail)[0] != nbytes:
                raise ValueError(f"{path}: corrupt record markers")
            if nbytes != 9 * n * n * 4:
                raise ValueError(
                    f"{path}: record size {nbytes} does not match "
                    f"9 x {n}x{n} REAL matrices")
            mats = np.frombuffer(payload, dtype="<f4").astype(np.float64)
            mats = mats.reshape(9, n, n)
            # undo the Fortran element order per matrix
            mats = np.transpose(mats.reshape(9, n, n), (0, 2, 1))
            records.append(mats.reshape(3, 3, n, n))
    return np.stack(records)


# ---------------------------------------------------------------------------
# Per-module trace logs (-*.Log keywords)
# ---------------------------------------------------------------------------
# The reference narrates each module into an optional ASCII trace file
# (catalogue src/SOS_ABS_MAIN.F:403-435; Mie trace src/SOS_MIE.F:341-387;
# profile unit 88; OS unit 99 src/SOS_OS.F:1306-1415).  These writers emit
# the same information from the in-memory pipeline products.

def write_ang_log(path, lum, mie_grid, os_nb, os_ns, os_nm,
                  thetas_deg) -> None:
    """Angle-grid trace (-ANG.Log, FICANGLOG)."""
    with open(path, "w") as f:
        f.write("TRACE ANGLES\n")
        f.write("Solar zenith angle (deg): %9.4f\n" % thetas_deg)
        f.write("Expansion orders: OS_NB=%d OS_NS=%d OS_NM=%d\n"
                % (os_nb, os_ns, os_nm))
        for name, g in (("LUM (radiance)", lum), ("MIE (phase fn)",
                                                  mie_grid)):
            f.write("\n%s grid: %d angles\n" % (name, g.mu.shape[0]))
            f.write("  I   cos(theta)            weight                "
                    "theta(deg)\n")
            for i, (m, w) in enumerate(zip(g.mu, g.w)):
                f.write(" %3d %s %s %9.4f\n"
                        % (i + 1, _d21(m), _d21(w),
                           np.degrees(np.arccos(min(m, 1.0)))))
        f.write("\nJOB_STATUS=OK\n")


def write_aer_log(path, expansion, ta) -> None:
    """Aerosol/granulometry trace (-AER.Log, FICGRANU_LOG)."""
    e = expansion
    with open(path, "w") as f:
        f.write("TRACE AEROSOLS (granulometry integration + expansion)\n")
        f.write("AOT at simulation wavelength     : %13.6E\n" % ta)
        f.write("Extinction cross section (mic^2) : %13.6E\n" % e.sigma_ext)
        f.write("Scattering cross section (mic^2) : %13.6E\n" % e.sigma_sca)
        f.write("Single scattering albedo         : %9.5f\n" % e.piz)
        f.write("Truncation coefficient A         : %9.5f\n"
                % e.coef_tronca)
        f.write("Albedo after truncation          : %9.5f\n" % e.piz_tronc)
        f.write("\nGSF expansion coefficients (K, ALPHA, BETA, GAMMA, "
                "ZETA):\n")
        for k in range(len(np.asarray(e.beta))):
            f.write(" %3d  %13.5E  %13.5E  %13.5E  %13.5E\n"
                    % (k, e.alpha[k], e.beta[k], e.gamma[k], e.zeta[k]))
        f.write("\nJOB_STATUS=OK\n")


def write_mie_log(path, sweeps, max_lines_per_sweep: int = 2000) -> None:
    """Mie computation trace (-AER.MieLog; reference per-alpha narration
    ``src/SOS_MIE.F:341-387``).  ``sweeps``: list of dicts with keys
    rn/in_/alpha/qext/qsca/g recorded by ``mie.SWEEP_LOG``."""
    with open(path, "w") as f:
        f.write("TRACE MIE COMPUTATIONS\n")
        if not sweeps:
            f.write("(no Mie sweep ran: cached, external or "
                    "aerosol-free case)\n")
        for k, s in enumerate(sweeps):
            al = np.asarray(s["alpha"])
            stride = max(1, int(np.ceil(al.shape[0]
                                        / max_lines_per_sweep)))
            f.write("\nSweep %d: m = %9.4f - %9.4fi, %d size parameters "
                    "alpha in [%g, %g]" % (k + 1, s["rn"], -s["in_"],
                                           al.shape[0], al[0], al[-1]))
            f.write(" (every %d-th listed)\n" % stride if stride > 1
                    else "\n")
            f.write("   ALPHA        QEXT          QSCA          G\n")
            for i in range(0, al.shape[0], stride):
                f.write(" %10.4f %13.5E %13.5E %13.5E\n"
                        % (al[i], s["qext"][i], s["qsca"][i], s["g"][i]))
        f.write("\nJOB_STATUS=OK\n")


def write_ap_log(path, hs, xds, yds, zprofs, ttot_vrai_terms,
                 full_terms: int = 1) -> None:
    """Atmospheric-profile trace (-AP.Log; reference unit 88,
    ``src/SOS_PROFIL.F``).  Per-level table for the first ``full_terms``
    CKD terms + one summary line per remaining term."""
    n_terms = hs.shape[0]
    with open(path, "w") as f:
        f.write("TRACE ATMOSPHERIC PROFILE (after truncation "
                "adjustment)\n")
        f.write("CKD terms: %d;  levels per term: %d\n"
                % (n_terms, hs.shape[1]))
        for t in range(min(full_terms, n_terms)):
            f.write("\nterm %d: tau_total(true)=%13.6E "
                    "tau_total(truncated)=%13.6E\n"
                    % (t, ttot_vrai_terms[t], hs[t, -1]))
            f.write("   I    Z(km)        H(tau)        XDEL          "
                    "YDEL\n")
            for i in range(hs.shape[1]):
                f.write(" %4d %10.4f %s %13.6E %13.6E\n"
                        % (i, zprofs[t, i], _d21(hs[t, i]), xds[t, i],
                           yds[t, i]))
        for t in range(full_terms, n_terms):
            f.write("term %d: tau_total(true)=%13.6E "
                    "tau_total(truncated)=%13.6E\n"
                    % (t, ttot_vrai_terms[t], hs[t, -1]))
        f.write("\nJOB_STATUS=OK\n")


def write_surf_log(path, isurf, params: dict, rmat) -> None:
    """Surface-matrix trace (-SURF.Log)."""
    with open(path, "w") as f:
        f.write("TRACE SURFACE\n")
        f.write("ISURF type: %d\n" % isurf)
        for k, v in params.items():
            f.write("  %-16s: %s\n" % (k, v))
        if rmat is None:
            f.write("no Fourier reflection matrices for this type\n")
        else:
            rmat = np.asarray(rmat)
            f.write("Fourier reflection matrices: %d orders, "
                    "%dx%d angles\n" % (rmat.shape[0], rmat.shape[3],
                                        rmat.shape[4]))
            f.write("  IS   max|R11|      max|R12|      max|R33|\n")
            for s in range(rmat.shape[0]):
                f.write(" %3d %13.5E %13.5E %13.5E\n"
                        % (s, np.abs(rmat[s, 0, 0]).max(),
                           np.abs(rmat[s, 0, 1]).max(),
                           np.abs(rmat[s, 2, 2]).max()))
        f.write("\nJOB_STATUS=OK\n")


def write_sos_log(path, ig_last, stop_code, emoins, eplus,
                  full_terms: int = 4) -> None:
    """OS solver convergence narration (-SOS.Log; reference unit 99,
    per-IS/IG narration ``src/SOS_OS.F:1306-1415``)."""
    names = {0: "igmax", 1: "geom-conv", 2: "valdif", 3: "sumdif"}
    ig = np.asarray(ig_last)
    code = np.asarray(stop_code)
    with open(path, "w") as f:
        f.write("TRACE SOS CORE (per-order scattering convergence)\n")
        f.write("terms: %d;  Fourier orders solved per term: %d\n"
                % (ig.shape[0], ig.shape[1]))
        f.write("EMOINS (downward flux, term 0): %13.6E\n"
                % np.asarray(emoins).ravel()[0])
        f.write("EPLUS  (upward flux, term 0)  : %13.6E\n"
                % np.asarray(eplus).ravel()[0])
        for t in range(min(full_terms, ig.shape[0])):
            f.write("\nterm %d:\n  IS   IG  stop\n" % t)
            for s in range(ig.shape[1]):
                f.write(" %3d %4d  %s\n"
                        % (s, ig[t, s], names.get(int(code[t, s]),
                                                  str(code[t, s]))))
        if ig.shape[0] > full_terms:
            f.write("\n(%d further terms: IG mean %.2f, max %d)\n"
                    % (ig.shape[0] - full_terms,
                       float(ig[full_terms:].mean()),
                       int(ig[full_terms:].max())))
        f.write("\nJOB_STATUS=OK\n")
