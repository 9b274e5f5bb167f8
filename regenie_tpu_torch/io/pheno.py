"""Phenotype & covariate tables, missingness masks, covariate basis —
the port's copy of regenie_tpu/io/pheno.py, trimmed to the four trait
types (quantitative, binary, count and time-to-event).

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

from ..config import BT, CT, MISSING, QT, T2E, Params
from .files import open_read, string_split

_MISS_STRINGS = ("NA", "nan", "inf", "-nan", "-inf")


def _to_double(tok: str) -> float:
    if tok in _MISS_STRINGS:
        return MISSING
    try:
        return float(tok)
    except ValueError as e:
        raise ValueError(f"could not convert value to numeric: '{tok}'") from e


# whitespace that str.split() splits on and string_split does not
_ODD_SPACE = "\v\f\x1c\x1d\x1e\x1f"


def _table_tokens(fh, ncol: int, what: str) -> np.ndarray:
    """The rest of a whitespace-separated table after its header: an
    object array [rows, ncol] of its tokens, blank lines skipped; a line
    with another number of fields raises ValueError. When the text is
    ASCII with no whitespace but spaces, tabs and newlines, the tokens come
    from one split of the whole text and each line's field count from
    numpy over its bytes (a biobank table of 400,000 x 52 fields in a few
    seconds); otherwise line by line through string_split."""
    text = fh.read()
    if text.isascii() and not any(c in text for c in _ODD_SPACE):
        toks = text.split()
        b = np.frombuffer(text.encode("ascii"), np.uint8)
        sep = (b == 32) | (b == 9) | (b == 10)
        starts = np.flatnonzero(~sep & np.concatenate(([True], sep[:-1])))
        counts = np.bincount(np.searchsorted(np.flatnonzero(b == 10), starts))
        counts = counts[counts > 0]
    else:
        lines = [t for t in map(string_split, text.split("\n")) if t]
        counts = np.array([len(t) for t in lines])
        toks = [x for t in lines for x in t]
    if (counts != ncol).any():
        raise ValueError(f"incorrectly formatted {what} file")
    return np.array(toks, dtype=object).reshape(-1, ncol)


def _row_index(tok, sample_index: Dict[str, int], what: str):
    """(table rows of the samples in sample_index, in file order; their
    sample indices). A sample on two rows raises ValueError."""
    keys = [f"{a}_{b}" for a, b in zip(tok[:, 0], tok[:, 1])]
    idx = np.fromiter((sample_index.get(k, -1) for k in keys), np.int64,
                      len(keys))
    rows = np.flatnonzero(idx >= 0)
    idx = idx[rows]
    _, first = np.unique(idx, return_index=True)
    if len(first) != len(idx):
        dup = np.ones(len(idx), dtype=bool)
        dup[first] = False
        key = keys[rows[np.flatnonzero(dup)[0]]]
        raise ValueError(f"individual appears more than once in {what} file: {key}")
    return rows, idx


def _block(tok: np.ndarray, rows: np.ndarray, cols) -> np.ndarray:
    """tok[rows][:, cols], by slicing where rows or cols are all of a
    run (a view: float() runs about twice as fast over it as over a
    fancy-indexed copy)."""
    cols = np.asarray(cols)
    if len(cols) and (np.diff(cols) == 1).all():
        out = tok[:, cols[0] : cols[-1] + 1]
    else:
        out = tok[:, cols]
    return out if len(rows) == len(tok) else out[rows]


def _to_doubles(tok: np.ndarray) -> np.ndarray:
    """_to_double over an object array of tokens: float() on each, and
    MISSING for the missing-value strings ("NA" fails float(); the others
    parse to a non-finite value, so only those tokens are looked at)."""
    miss = tok == "NA"
    try:
        v = np.where(miss, "0", tok).astype(np.float64)
    except (ValueError, TypeError):
        for x in tok[~miss].ravel():  # the first token float() rejects
            _to_double(x)
        raise
    odd = np.flatnonzero(~np.isfinite(v.ravel()))
    miss.ravel()[odd] = [x in _MISS_STRINGS for x in tok.ravel()[odd]]
    v[miss] = MISSING
    return v


@dataclass
class PhenoData:
    """Mirror of the reference `struct phenodt` (src/Pheno.hpp:35-51)."""

    phenotypes: np.ndarray = None  # [N, P] residualized+scaled for QT
    phenotypes_raw: np.ndarray = None  # [N, P] raw values (not QT)
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
                # T2E: event columns have no step-1 predictions (Pheno.cpp:183)
                if not (params.trait_mode == T2E and name in params.event_cols):
                    keep_cols[i] = name in blup_pheno_names
        names = [nm for nm, k in zip(all_names, keep_cols) if k]
        n_pheno = len(names)
        if n_pheno < 1:
            raise ValueError("need at least one phenotype")

        # single-pheno runs force strict mode (Pheno.cpp:201)
        strict = params.strict_mode or (n_pheno == 1)

        tok = _table_tokens(fh, 2 + len(all_names), "phenotype")

    rows, idx = _row_index(tok, sample_index, "phenotype")
    vals = _to_doubles(_block(tok, rows, 2 + np.flatnonzero(keep_cols)))
    bt = params.trait_mode == BT
    if bt and params.cc12:
        vals = np.where(vals == MISSING, vals, vals - 1.0)  # 1/2/NA coding
    miss = vals == MISSING
    # strict: a sample's first missing value ends its row (every trait
    # masked); the traits after it are neither stored nor checked
    lost = miss.any(axis=1) if strict else np.zeros(len(rows), dtype=bool)
    seen = np.arange(n_pheno)[None, :] <= np.where(
        lost, miss.argmax(axis=1), n_pheno)[:, None]
    if bt:
        bad = seen & ~miss & (vals != 0.0) & (vals != 1.0)
        if bad.any():
            r = rows[np.flatnonzero(bad.any(axis=1))[0]]
            raise ValueError(
                f"phenotype value not 0/1/NA for FID={tok[r, 0]} IID={tok[r, 1]}")
    ct = params.trait_mode == CT
    if ct and (seen & ~miss & (vals < 0)).any():
        raise ValueError("count phenotype value < 0")
    # a missing binary or count value masks the sample for that trait
    # (time-to-event values are checked after the read, time against event)
    m = ~(miss & (bt or ct or (params.test_mode and params.rm_missing_qt
                                and params.trait_mode == QT)))
    m[lost] = False
    Y = np.zeros((n, n_pheno), dtype=np.float64)
    Y[idx] = np.where(seen, vals, 0.0)
    mask = np.ones((n, n_pheno), dtype=bool)
    mask[idx] = m
    ind_in_pheno = np.zeros(n, dtype=bool)
    ind_in_pheno[idx] = ~(miss.all(axis=1) | lost)

    mask &= ind_in_pheno[:, None]

    # drop BTs with too few cases (rm_phenoCols, Pheno.cpp:528-543)
    if params.trait_mode == BT and params.min_case_count > 0:
        ncases = ((Y == 1.0) & mask).sum(axis=0)
        colrm = ncases < params.min_case_count
        if colrm.all():
            raise ValueError(
                f"all phenotypes have less than {params.min_case_count} cases."
            )
        if colrm.any():
            keep = ~colrm
            Y = Y[:, keep]
            mask = mask[:, keep]
            names = [nm for nm, k in zip(names, keep) if k]
            n_pheno = len(names)

    nobs = mask.sum(axis=0)
    if (nobs == 0).all():
        raise ValueError("all individuals have missing/invalid values for all traits")
    if nobs.min() == 0:
        bad = names[int(np.argmin(nobs))]
        raise ValueError(f"all individuals have missing/invalid values for phenotype '{bad}'")

    pd = PhenoData()
    pd.phenotypes = Y
    pd.phenotypes_raw = Y.copy() if params.trait_mode != QT else None
    pd.masked_indivs = mask
    pd.pheno_names = names
    pd.ind_in_analysis = ind_in_pheno
    pd.pheno_pass = np.ones(n_pheno, dtype=bool)
    if params.trait_mode == T2E:
        # pair time/event columns; event columns are not tested themselves
        # and missing time masks both (pheno_read T2E branch, Pheno.cpp:236)
        name_idx = {nm: i for i, nm in enumerate(names)}
        for tname, ename in params.t2e_map.items():
            ti, ei = name_idx[tname], name_idx[ename]
            pd.pheno_pass[ei] = False
            bad = (Y[:, ti] == MISSING) | (Y[:, ti] < 0) | (Y[:, ei] == MISSING)
            pd.masked_indivs[bad, ti] = False
            pd.masked_indivs[bad, ei] = False
    params.n_pheno = n_pheno
    params.strict_mode = strict
    return pd


def read_covariates(
    params: Params,
    sample_index: Dict[str, int],
    pheno_names: List[str],
) -> tuple:
    """Read covariates -> design matrix [N, 1+C] with intercept + dummies.

    Reference covariate_read (Pheno.cpp:573): categorical covariates are
    dummy-coded with first-seen level as baseline; individuals with any
    missing covariate are dropped from the analysis.
    The --interaction covariate is kept apart from the design
    (covariate_read, Pheno.cpp:673-700): a column [N, 1], or for a
    categorical one its dummies [N, L - 1] and their level names.
    Returns (new_cov, ind_in_cov, the design's column names, the
    interaction covariate as (matrix, is categorical, level names) or
    None).
    """
    n = params.n_samples
    inter_name = (params.interaction_var
                  if (params.interaction_var and not params.interaction_snp
                      and not params.interaction_prs) else None)
    if not params.cov_file:
        if inter_name is not None:
            raise ValueError("cannot find the interaction covariate in the covariate file")
        return (np.ones((n, 1), dtype=np.float64), np.ones(n, dtype=bool),
                ["Intercept"], None)

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
                    or (name == inter_name)
                )
            if name in pheno_names:
                keep_cols[i] = False
            if keep_cols[i]:
                is_cat[name] = name in params.cat_cov_cols
        names = [nm for nm, k in zip(all_names, keep_cols) if k]
        n_cov = len(names)
        if n_cov == 0:
            if inter_name is not None:
                raise ValueError("cannot find the interaction covariate in the "
                                 "covariate file")
            return (np.ones((n, 1), dtype=np.float64), np.ones(n, dtype=bool),
                    ["Intercept"], None)

        tok = _table_tokens(fh, 2 + len(all_names), "covariate")

    rows, idx = _row_index(tok, sample_index, "covariate")
    R = len(rows)
    Xr = np.zeros((R, n_cov), dtype=np.float64)
    # a sample's first missing covariate ends its row: it leaves the
    # analysis, and its later covariates are neither read nor counted as
    # categories
    alive = np.ones(R, dtype=bool)
    cat_maps: Dict[str, Dict[str, int]] = {}
    for ic, j in enumerate(np.flatnonzero(keep_cols)):
        nm = names[ic]
        t = _block(tok, rows, [2 + j])[:, 0]
        v = np.zeros(R)
        if is_cat[nm]:
            # levels coded in the order they first appear in the file
            v[:] = MISSING
            reg = alive & ~np.isin(t, _MISS_STRINGS)
            levels, first = np.unique(t[reg].astype(str), return_index=True)
            cmap = cat_maps[nm] = {
                str(lv): i for i, lv in enumerate(levels[np.argsort(first)])}
            v[reg] = [cmap[x] for x in t[reg]]
        else:
            v[alive] = _to_doubles(t[alive])
        Xr[alive, ic] = v[alive]
        alive &= v != MISSING
    X = np.zeros((n, n_cov), dtype=np.float64)
    X[idx] = Xr
    ind_in_cov = np.zeros(n, dtype=bool)
    ind_in_cov[idx] = alive

    if ind_in_cov.sum() == 0:
        raise ValueError("none of the individuals have covariate data")

    X *= ind_in_cov[:, None]

    # build design: intercept + quantitative cols + dummies for categorical;
    # the interaction covariate stays apart (covariate_read,
    # Pheno.cpp:673-700)
    cols = [np.ones(n, dtype=np.float64)]
    col_names = ["Intercept"]
    inter = None
    for ic, nm in enumerate(names):
        if nm == inter_name:
            if is_cat[nm]:
                nd = int(X[:, ic].max())
                lv = sorted(cat_maps[nm], key=cat_maps[nm].get)
                inter = (np.stack([(X[:, ic] == lev).astype(np.float64)
                                   for lev in range(1, nd + 1)], axis=1),
                         True, lv[1:])
            else:
                inter = (X[:, ic : ic + 1].copy(), False, [nm])
            continue
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
    if inter_name is not None and inter is None:
        raise ValueError("cannot find the interaction covariate in the covariate file")
    return np.column_stack(cols), ind_in_cov, col_names, inter


def set_masks(params: Params, pd: PhenoData, ind_in_analysis: np.ndarray) -> None:
    """Finalize per-trait masks and counts (reference setMasks, Pheno.cpp:810)."""
    if params.strict_mode:
        ind_in_analysis = ind_in_analysis & pd.masked_indivs.all(axis=1)
    else:
        ind_in_analysis = ind_in_analysis & pd.masked_indivs.any(axis=1)
    pd.masked_indivs = pd.masked_indivs & ind_in_analysis[:, None]
    pd.phenotypes = pd.phenotypes * ind_in_analysis[:, None]
    if pd.phenotypes_raw is not None:
        pd.phenotypes_raw = pd.phenotypes_raw * ind_in_analysis[:, None]
    pd.new_cov = pd.new_cov * ind_in_analysis[:, None].astype(np.float64)
    pd.ind_in_analysis = ind_in_analysis
    params.n_analyzed = int(ind_in_analysis.sum())
    if params.n_analyzed < 1:
        raise ValueError("sample size cannot be < 1")
    pd.Neff = pd.masked_indivs.sum(axis=0).astype(np.float64)


def pheno_impute_miss(params: Params, pd: PhenoData) -> None:
    """Mean-impute missing phenotype values (reference Pheno.cpp:1903):
    QT: missing -> mean over in-analysis non-missing, then zero masked;
    binary and count traits in Step 1: missing -> masked mean (then
    zeroed with the mask). Step 2 leaves binary and count traits as read
    (their null fits mask the missing)."""
    if params.trait_mode != QT and params.test_mode:
        return
    for j in range(params.n_pheno):
        if not pd.pheno_pass[j]:
            continue
        y = pd.phenotypes[:, j]
        if params.trait_mode == QT:
            nonmiss = y != MISSING
            ok = pd.ind_in_analysis & nonmiss
            y[~nonmiss] = y[ok].sum() / ok.sum()
        else:
            m = pd.masked_indivs[:, j]
            y[~m] = y[m].sum() / m.sum()
    pd.phenotypes *= pd.masked_indivs.astype(np.float64)


def get_basis(X: np.ndarray, params: Params) -> Tuple[np.ndarray, int]:
    """Orthonormal covariate basis via eigendecomposition of X'X
    (reference getBasis, Pheno.cpp:1660). Returns (basis, rank)."""
    if X.shape[1] == 0:
        # T2E with no covariates: Cox drops the intercept (the baseline
        # hazard absorbs it), so the design can legitimately be empty
        return X.copy(), 0
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
