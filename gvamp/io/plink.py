"""PLINK file-format readers/writers (.bed / .bim / .fam / .phen / covariates).

Replaces the reference's MPI-IO collective reads (data.cpp:201-234,
utilities.hpp:67-92) with per-host byte-range reads: each host reads only the
marker slab its devices own — offset ``3 + S * mbytes`` bytes into the
``.bed`` (3-byte magic header, one row of ``ceil(N/4)`` packed bytes per
marker in SNP-major order).

A native C++ reader (gvamp.io.native) accelerates the slab read +
word-transpose; this module is the pure-NumPy fallback and the format
authority used by tests.
"""

from __future__ import annotations

import os

import numpy as np

BED_MAGIC = bytes([0x6C, 0x1B, 0x01])  # v1.00 SNP-major


def bed_mbytes(n_samples: int) -> int:
    return (n_samples + 3) // 4


def read_bed_slab(path: str, n_samples: int, m_markers: int, s_offset: int = 0) -> np.ndarray:
    """Read markers [s_offset, s_offset + m_markers) as uint8[M, mbytes].

    Mirrors the reference's per-rank slab read (data.cpp:215: offset
    ``3 + S*mbytes``), without the INT_MAX chunking MPI needs.
    """
    mb = bed_mbytes(n_samples)
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != BED_MAGIC:
            raise ValueError(f"{path}: not a SNP-major PLINK v1 .bed file (magic {magic!r})")
        total_m = (fsize - 3) // mb
        if s_offset + m_markers > total_m:
            raise ValueError(
                f"{path}: requested markers [{s_offset}, {s_offset + m_markers}) "
                f"but file holds {total_m} markers of {mb} bytes"
            )
        f.seek(3 + s_offset * mb)
        raw = np.fromfile(f, dtype=np.uint8, count=m_markers * mb)
    return raw.reshape(m_markers, mb)


def write_bed(path: str, codes: np.ndarray) -> None:
    """Write 2-bit PLINK codes uint8[M, N] (values 0..3) as a .bed file."""
    M, N = codes.shape
    mb = bed_mbytes(N)
    by = np.zeros((M, mb), dtype=np.uint8)
    for k in range(4):
        cols = np.arange(k, N, 4)
        by[:, (cols - k) // 4] |= (codes[:, cols].astype(np.uint8) << (2 * k))
    with open(path, "wb") as f:
        f.write(BED_MAGIC)
        by.tofile(f)


def dosage_to_codes(geno: np.ndarray) -> np.ndarray:
    """Dosage matrix (0/1/2, NaN=missing) -> PLINK 2-bit codes.

    Inverse of the decode tables: dosage 2 -> code 0, 1 -> 2, 0 -> 3,
    missing -> 1 (reference dotp_lut.hpp:3 comments).
    """
    codes = np.full(geno.shape, 1, dtype=np.uint8)
    codes[geno == 2] = 0
    codes[geno == 1] = 2
    codes[geno == 0] = 3
    return codes


# --------------------------------------------------------------------------
# Phenotype (.phen: FID IID VALUE, one row per individual; reference
# data.cpp:128-192)
# --------------------------------------------------------------------------


def read_phen(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (values float64[N] with NaN at 'NA', isna bool[N])."""
    vals, isna = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[2] == "NA":
                vals.append(np.nan)
                isna.append(True)
            else:
                vals.append(float(tok[2]))
                isna.append(False)
    return np.asarray(vals, dtype=np.float64), np.asarray(isna, dtype=bool)


def write_phen(path: str, values: np.ndarray, fids=None, iids=None) -> None:
    with open(path, "w") as f:
        for i, v in enumerate(values):
            fid = fids[i] if fids is not None else f"F{i}"
            iid = iids[i] if iids is not None else f"I{i}"
            sval = "NA" if (isinstance(v, float) and np.isnan(v)) or np.isnan(v) else repr(float(v))
            f.write(f"{fid} {iid} {sval}\n")


# --------------------------------------------------------------------------
# Covariates (whitespace-separated C columns per individual; reference
# data.cpp:286-331)
# --------------------------------------------------------------------------


def read_covariates(path: str, n_cov: int) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if len(tok) != n_cov:
                raise ValueError(
                    f"{path}: found {len(tok)} covariates on a row, expected {n_cov}"
                )
            rows.append([float(t) for t in tok])
    return np.asarray(rows, dtype=np.float64)


def write_covariates(path: str, Z: np.ndarray) -> None:
    np.savetxt(path, Z, fmt="%.17g")


# --------------------------------------------------------------------------
# .bim (marker table; only the chromosome column is consumed, 'X' -> 23;
# reference data.cpp:346-380)
# --------------------------------------------------------------------------


def read_chromosomes(path: str, m_markers: int | None = None, s_offset: int = 0) -> np.ndarray:
    chroms = []
    with open(path) as f:
        for ln, line in enumerate(f):
            if m_markers is not None and ln >= s_offset + m_markers:
                break
            if ln < s_offset:
                continue
            tok = line.split()
            chroms.append(23 if tok[0] == "X" else int(float(tok[0])))
    return np.asarray(chroms, dtype=np.int32)


def write_bim(path: str, chroms: np.ndarray) -> None:
    with open(path, "w") as f:
        for i, c in enumerate(chroms):
            f.write(f"{int(c)} snp{i} 0 {i} A B\n")


def read_meth_slab(path: str, n_samples: int, m_markers: int,
                   s_offset: int = 0) -> np.ndarray:
    """Raw methylation matrix slab: float64[m_markers, n_samples], row-major,
    starting at marker ``s_offset`` (reference read_methylation_data,
    data.cpp:241-278 — binary doubles, no header)."""
    out = np.fromfile(path, dtype="<f8", count=m_markers * n_samples,
                      offset=8 * s_offset * n_samples)
    if out.size != m_markers * n_samples:
        raise ValueError(
            f"{path}: expected {m_markers}x{n_samples} doubles at offset "
            f"{s_offset}, got {out.size} values")
    return out.reshape(m_markers, n_samples)


def write_meth(path: str, X: np.ndarray) -> None:
    """Write a dense methylation matrix as raw row-major doubles."""
    np.asarray(X, dtype="<f8").tofile(path)
