"""Shared test utilities: dense NumPy oracle of the reference semantics."""

from __future__ import annotations

import numpy as np

# backend name of the GPU kernel family run in the Pallas interpreter: the
# tests' way to reach the kernels on a host without a GPU
KERNEL = "interpret"

CODE_A = np.array([2.0, 0.0, 1.0, 0.0])  # dosage per 2-bit code
CODE_B = np.array([1.0, 0.0, 1.0, 1.0])  # non-missing indicator


def random_dataset(rng, N, M, miss_geno=0.05, miss_phen=0.1):
    """Random codes uint8[M, N], raw phenotype float64[N] with NaNs."""
    codes = rng.choice([0, 2, 3], size=(M, N), p=[0.25, 0.5, 0.25]).astype(np.uint8)
    miss = rng.random((M, N)) < miss_geno
    codes[miss] = 1
    y = rng.normal(2.0, 3.0, size=N)
    y[rng.random(N) < miss_phen] = np.nan
    return codes, y


class DenseOracle:
    """float64 re-statement of the reference data-layer math (data.cpp)."""

    def __init__(self, codes, y_raw, alpha_scale=1.0, standardize_phen=True):
        self.M, self.N = codes.shape
        self.a = CODE_A[codes]          # [M, N]
        self.b = CODE_B[codes]
        self.isna = np.isnan(y_raw)
        self.na = (~self.isna).astype(np.float64)
        self.nonas = int(self.na.sum())
        if standardize_phen:
            avg = np.nanmean(y_raw)
            sqn = np.sqrt((self.nonas - 1) / np.nansum((y_raw - avg) ** 2))
            self.intercept, self.scale = avg, sqn
            self.y = np.where(self.isna, 0.0, y_raw * sqn)
        else:
            self.intercept, self.scale = 0.0, 1.0
            self.y = np.where(self.isna, 0.0, y_raw)

        mask = self.b * self.na[None, :]
        cnt = mask.sum(1)
        self.mave = np.where(cnt > 0, (self.a * mask).sum(1) / np.maximum(cnt, 1), 0.0)
        dev = (self.a - self.mave[:, None]) * mask
        sumsqr = (dev**2).sum(1)
        sd = np.sqrt(sumsqr / (self.nonas - 1))
        self.msig = np.where(
            sumsqr != 0, 1.0 / np.power(np.where(sd == 0, 1, sd), alpha_scale), 1.0
        )
        # standardized design matrix WITHOUT the NA mask folded in; the NA
        # mask applies to Ax outputs / ATx inputs like the reference
        self.A = (self.a - self.mave[:, None]) * self.b * self.msig[:, None] / np.sqrt(self.N)

    def ax(self, x):
        return (self.A.T @ x) * self.na

    def atx(self, v):
        return self.A @ (v * self.na)
