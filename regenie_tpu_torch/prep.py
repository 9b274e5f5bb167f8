"""Data preparation for Step 2 QT (the port's copy of regenie_tpu/prep.py,
trimmed to the quantitative-trait run-up).

Mirrors the reference's run-up sequence (Data::run_step2 ->
file_read_initialization, read_pheno_and_cov, prep_run; Data.cpp:95-180,
Pheno.cpp:50-146, :1060).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .config import Params
from .io.geno import GenoData, open_geno
from .io.pheno import (
    PhenoData,
    get_basis,
    pheno_impute_miss,
    read_covariates,
    read_pheno,
    residualize_phenotypes,
    rint_values,
    set_masks,
)


@dataclass
class RunData:
    geno: GenoData
    pheno: PhenoData


def prepare(
    params: Params,
    blup_pheno_names: Optional[List[str]] = None,
    log=print,
) -> RunData:
    gd = open_geno(params)
    sample_index = gd.sample_index()

    pd = read_pheno(params, sample_index, blup_pheno_names)
    new_cov, ind_in_cov = read_covariates(params, sample_index, pd.pheno_names)
    # covariate-count log line greppable as in the reference (Pheno.cpp:642)
    log(f"n_cov = {new_cov.shape[1] - 1}")
    pd.new_cov = new_cov

    ind = pd.ind_in_analysis & ind_in_cov
    pd.masked_indivs &= ind[:, None]
    set_masks(params, pd, ind)

    if params.apply_rint:
        for j in range(params.n_pheno):
            m = (pd.phenotypes[:, j] != -999.0) & pd.masked_indivs[:, j]
            pd.phenotypes[:, j] = rint_values(pd.phenotypes[:, j], m)

    pheno_impute_miss(params, pd)

    # orthonormal covariate basis (prep_run, Pheno.cpp:1060-1117)
    basis, ncov = get_basis(pd.new_cov, params)
    pd.new_cov = basis * pd.ind_in_analysis[:, None]
    params.ncov = ncov
    params.ncov_analyzed = ncov

    # --prs-cov: step-1 predictions enter as a covariate (check_cov_blup,
    # Pheno.cpp:1786-1797)
    if params.blup_cov and params.test_mode:
        params.ncov_analyzed = params.ncov + 1

    # --nocov-approx: only valid for a single phenotype (Pheno.cpp:1119)
    if params.skip_cov_res and params.n_pheno != 1:
        params.skip_cov_res = False
        print(" WARNING: --nocov-approx is only available with a single "
              "phenotype; ignoring it.")

    residualize_phenotypes(params, pd)
    return RunData(geno=gd, pheno=pd)


def fmt(x: float) -> str:
    """C++ default ostream formatting (6 significant digits, %g rules)."""
    if isinstance(x, (float, np.floating)) and np.isnan(x):
        return "nan"
    return f"{x:g}"
