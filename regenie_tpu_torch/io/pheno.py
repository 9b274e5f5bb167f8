"""Phenotype & covariate tables, missingness masks, covariate basis —
the port's copy of regenie_tpu/io/pheno.py, trimmed to quantitative
traits.

Equivalent of the reference's `src/Pheno.{hpp,cpp}`: pheno_read
(Pheno.cpp:148), covariate_read (:573), setMasks (:810), getBasis
(:1660), residualize_phenotypes (:1799), pheno_impute_miss (:1903),
rint_pheno (:1975).

All host-side numpy float64; results are handed to the device pipeline as
dense arrays + [N, P] boolean masks which every kernel carries through.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.stats import norm as _norm

from ..config import MISSING, Params
from .files import open_read, string_split

_MISS_STRINGS = ("NA", "nan", "inf", "-nan", "-inf")


def _to_double(tok: str) -> float:
    if tok in _MISS_STRINGS:
        return MISSING
    try:
        return float(tok)
    except ValueError as e:
        raise ValueError(f"could not convert value to numeric: '{tok}'") from e


@dataclass
class PhenoData:
    """Mirror of the reference `struct phenodt` (src/Pheno.hpp:35-51)."""

    phenotypes: np.ndarray = None  # [N, P] residualized+scaled
    masked_indivs: np.ndarray = None  # [N, P] bool
    new_cov: np.ndarray = None  # [N, K] covariates (orthonormal basis after prep)
    Neff: np.ndarray = None  # [P] per-trait non-masked count
    scale_Y: np.ndarray = None  # [P]
    pheno_names: List[str] = field(default_factory=list)
    ind_in_analysis: np.ndarray = None  # [N] bool
    pheno_pass: np.ndarray = None  # [P] bool


def convert_tpheno(params: Params) -> None:
    """Convert a transposed phenotype file (--tpheno-file: header =
    sample IDs, one row per trait; tpheno_read Pheno.cpp:366) into the
    standard FID IID Y... format in a temporary file (the caller removes
    it once read) and repoint params.pheno_file at it."""
    import tempfile

    with open_read(params.pheno_file) as fh:
        header = string_split(fh.readline())
        rows = [string_split(l) for l in fh if l.strip()]
    idx_col = params.tpheno_index_col - 1
    rm = set(params.tpheno_ignore_cols) | {params.tpheno_index_col}
    keep = [i for i in range(len(header)) if (i + 1) not in rm]
    names = [r[idx_col] for r in rows]
    for r in rows:
        if len(r) != len(header):
            raise ValueError("incorrectly formatted phenotype file.")
    with tempfile.NamedTemporaryFile(
            "w", suffix=".pheno.txt", delete=False,
            prefix="regenie_tpheno_") as tmp:
        tmp.write("FID IID " + " ".join(names) + "\n")
        for i in keep:
            sid = header[i]
            if params.tpheno_iid_only:
                fid = iid = sid
            else:
                fid, _, iid = sid.partition("_")
                if not iid:
                    fid = iid = sid
            tmp.write(f"{fid} {iid} " + " ".join(r[i] for r in rows) + "\n")
    params.pheno_file = tmp.name


def read_pheno(
    params: Params,
    sample_index: Dict[str, int],
    blup_pheno_names: Optional[List[str]] = None,
) -> PhenoData:
    """Read the phenotype table (reference pheno_read, Pheno.cpp:148).

    sample_index maps "FID_IID" -> row in genotype sample order.
    Returns PhenoData with phenotypes/masks; also an ind_in_pheno flag in
    .ind_in_analysis (further intersected by covariates later).
    """
    n = params.n_samples
    with open_read(params.pheno_file) as fh:
        header = string_split(fh.readline())
        if len(header) < 2 or header[0] != "FID" or header[1] != "IID":
            raise ValueError("header of phenotype file must start with: FID IID")
        all_names = header[2:]
        keep_cols = np.ones(len(all_names), dtype=bool)
        for i, name in enumerate(all_names):
            if params.pheno_cols_rm and name in params.pheno_cols_rm:
                keep_cols[i] = False
            elif params.pheno_cols:
                keep_cols[i] = name in params.pheno_cols
            if keep_cols[i] and blup_pheno_names is not None:
                keep_cols[i] = name in blup_pheno_names
        names = [nm for nm, k in zip(all_names, keep_cols) if k]
        n_pheno = len(names)
        if n_pheno < 1:
            raise ValueError("need at least one phenotype")

        # single-pheno runs force strict mode (Pheno.cpp:201)
        strict = params.strict_mode or (n_pheno == 1)

        Y = np.zeros((n, n_pheno), dtype=np.float64)
        mask = np.ones((n, n_pheno), dtype=bool)
        ind_in_pheno = np.zeros(n, dtype=bool)
        seen = np.zeros(n, dtype=bool)

        for line in fh:
            toks = string_split(line)
            if not toks:
                continue
            if len(toks) != 2 + len(all_names):
                raise ValueError("incorrectly formatted phenotype file")
            key = f"{toks[0]}_{toks[1]}"
            if key not in sample_index:
                continue
            idx = sample_index[key]
            if seen[idx]:
                raise ValueError(f"individual appears more than once in phenotype file: {key}")
            seen[idx] = True
            ind_in_pheno[idx] = True

            all_miss = True
            ip = 0
            for j, kc in enumerate(keep_cols):
                if not kc:
                    continue
                v = _to_double(toks[2 + j])
                Y[idx, ip] = v
                if v != MISSING:
                    all_miss = False
                else:
                    if params.test_mode and params.rm_missing_qt:
                        mask[idx, ip] = False
                    if strict:
                        mask[idx, :] = False
                        all_miss = True
                        break
                ip += 1
            if all_miss:
                ind_in_pheno[idx] = False

    mask &= ind_in_pheno[:, None]

    nobs = mask.sum(axis=0)
    if (nobs == 0).all():
        raise ValueError("all individuals have missing/invalid values for all traits")
    if nobs.min() == 0:
        bad = names[int(np.argmin(nobs))]
        raise ValueError(f"all individuals have missing/invalid values for phenotype '{bad}'")

    pd = PhenoData()
    pd.phenotypes = Y
    pd.masked_indivs = mask
    pd.pheno_names = names
    pd.ind_in_analysis = ind_in_pheno
    pd.pheno_pass = np.ones(n_pheno, dtype=bool)
    params.n_pheno = n_pheno
    params.strict_mode = strict
    return pd


def read_covariates(
    params: Params,
    sample_index: Dict[str, int],
    pheno_names: List[str],
) -> Tuple[np.ndarray, np.ndarray]:
    """Read covariates -> design matrix [N, 1+C] with intercept + dummies.

    Reference covariate_read (Pheno.cpp:573): categorical covariates are
    dummy-coded with first-seen level as baseline; individuals with any
    missing covariate are dropped from the analysis.
    Returns (new_cov, ind_in_cov, the design's column names).
    """
    n = params.n_samples
    if not params.cov_file:
        return (np.ones((n, 1), dtype=np.float64), np.ones(n, dtype=bool),
                ["Intercept"])

    with open_read(params.cov_file) as fh:
        header = string_split(fh.readline())
        if header[0] != "FID" or header[1] != "IID":
            raise ValueError("header of covariate file must start with: FID IID")
        all_names = header[2:]
        keep_cols = np.ones(len(all_names), dtype=bool)
        is_cat: Dict[str, bool] = {}
        select = bool(params.cov_cols)  # --covarColList given => explicit selection
        for i, name in enumerate(all_names):
            if params.cov_cols_rm and name in params.cov_cols_rm:
                keep_cols[i] = False
                continue
            if select:
                keep_cols[i] = (
                    (name in params.cov_cols)
                    or (name in params.cat_cov_cols)
                )
            if name in pheno_names:
                keep_cols[i] = False
            if keep_cols[i]:
                is_cat[name] = name in params.cat_cov_cols
        names = [nm for nm, k in zip(all_names, keep_cols) if k]
        n_cov = len(names)
        if n_cov == 0:
            return (np.ones((n, 1), dtype=np.float64), np.ones(n, dtype=bool),
                    ["Intercept"])

        X = np.zeros((n, n_cov), dtype=np.float64)
        ind_in_cov = np.zeros(n, dtype=bool)
        seen = np.zeros(n, dtype=bool)
        cat_maps: Dict[str, Dict[str, int]] = {nm: {} for nm in names if is_cat[nm]}

        for line in fh:
            toks = string_split(line)
            if not toks:
                continue
            if len(toks) != 2 + len(all_names):
                raise ValueError("incorrectly formatted covariate file")
            key = f"{toks[0]}_{toks[1]}"
            if key not in sample_index:
                continue
            idx = sample_index[key]
            if seen[idx]:
                raise ValueError(f"individual appears more than once in covariate file: {key}")
            seen[idx] = True
            ind_in_cov[idx] = True
            ic = 0
            for j, kc in enumerate(keep_cols):
                if not kc:
                    continue
                nm = names[ic]
                tok = toks[2 + j]
                if is_cat[nm]:
                    if tok in _MISS_STRINGS:
                        v = MISSING
                    else:
                        cmap = cat_maps[nm]
                        if tok not in cmap:
                            cmap[tok] = len(cmap)
                        v = float(cmap[tok])
                else:
                    v = _to_double(tok)
                X[idx, ic] = v
                if v == MISSING:
                    ind_in_cov[idx] = False
                    break
                ic += 1

    if ind_in_cov.sum() == 0:
        raise ValueError("none of the individuals have covariate data")

    X *= ind_in_cov[:, None]

    # build design: intercept + quantitative cols + dummies for categorical
    # (covariate_read, Pheno.cpp:673-700)
    cols = [np.ones(n, dtype=np.float64)]
    col_names = ["Intercept"]
    for ic, nm in enumerate(names):
        if not is_cat[nm]:
            cols.append(X[:, ic])
            col_names.append(nm)
        else:
            nlev = len(cat_maps[nm])
            if nlev > params.max_cat_levels:
                raise ValueError(f"too many categories for covariate: {nm} (={nlev})")
            nd = int(X[:, ic].max())
            lv = sorted(cat_maps[nm], key=cat_maps[nm].get)
            for lev in range(1, nd + 1):
                cols.append((X[:, ic] == lev).astype(np.float64))
                col_names.append(f"{nm}={lv[lev]}" if lev < len(lv) else f"{nm}={lev}")
    return np.column_stack(cols), ind_in_cov, col_names


def set_masks(params: Params, pd: PhenoData, ind_in_analysis: np.ndarray) -> None:
    """Finalize per-trait masks and counts (reference setMasks, Pheno.cpp:810)."""
    if params.strict_mode:
        ind_in_analysis = ind_in_analysis & pd.masked_indivs.all(axis=1)
    else:
        ind_in_analysis = ind_in_analysis & pd.masked_indivs.any(axis=1)
    pd.masked_indivs = pd.masked_indivs & ind_in_analysis[:, None]
    pd.phenotypes = pd.phenotypes * ind_in_analysis[:, None]
    pd.new_cov = pd.new_cov * ind_in_analysis[:, None].astype(np.float64)
    pd.ind_in_analysis = ind_in_analysis
    params.n_analyzed = int(ind_in_analysis.sum())
    if params.n_analyzed < 1:
        raise ValueError("sample size cannot be < 1")
    pd.Neff = pd.masked_indivs.sum(axis=0).astype(np.float64)


def pheno_impute_miss(params: Params, pd: PhenoData) -> None:
    """Mean-impute missing QT values (reference Pheno.cpp:1903): missing
    -> mean over in-analysis non-missing, then zero masked."""
    for j in range(params.n_pheno):
        if not pd.pheno_pass[j]:
            continue
        y = pd.phenotypes[:, j]
        nonmiss = y != MISSING
        ok = pd.ind_in_analysis & nonmiss
        mu = y[ok].sum() / ok.sum()
        y[~nonmiss] = mu
    pd.phenotypes *= pd.masked_indivs.astype(np.float64)


def get_basis(X: np.ndarray, params: Params) -> Tuple[np.ndarray, int]:
    """Orthonormal covariate basis via eigendecomposition of X'X
    (reference getBasis, Pheno.cpp:1660). Returns (basis, rank)."""
    xtx = X.T @ X
    D, V = np.linalg.eigh(xtx)
    nz = int((D > D[-1] * params.eigen_val_rel_tol).sum())
    vv1 = np.sqrt(D[-nz:])
    B = (X @ V[:, -nz:]) / vv1[None, :]
    return B, nz


def residualize_phenotypes(params: Params, pd: PhenoData) -> None:
    """Project covariate basis out of Y, scale to unit variance
    (reference residualize_phenotypes, Pheno.cpp:1799)."""
    beta = pd.phenotypes.T @ pd.new_cov  # [P, K]
    pd.phenotypes = pd.phenotypes - (pd.new_cov @ beta.T) * pd.masked_indivs
    scale = np.linalg.norm(pd.phenotypes, axis=0) / np.sqrt(pd.Neff - params.ncov)
    scale = np.where(pd.pheno_pass, scale, 1.0)
    if scale.min() < params.numtol:
        bad = pd.pheno_names[int(np.argmin(scale))]
        raise ValueError(f"phenotype '{bad}' has sd=0")
    pd.phenotypes = pd.phenotypes / scale[None, :]
    pd.scale_Y = scale


def rint_values(y: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Rank-inverse-normal transform with Blom offset 3/8 and midranks for
    ties (reference rint_pheno, Pheno.cpp:1975)."""
    out = y.copy()
    vals = y[mask]
    nvals = len(vals)
    order = np.argsort(vals, kind="stable")
    ranks = np.empty(nvals, dtype=np.float64)
    sorted_vals = vals[order]
    i = 0
    while i < nvals:
        j = i
        while j + 1 < nvals and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + 1) + (j - i) / 2.0
        i = j + 1
    kc = 3.0 / 8.0
    out[mask] = _norm.ppf((ranks - kc) / (nvals - 2 * kc + 1))
    return out
