"""Data preparation for both steps (the port's copy of regenie_tpu/prep.py,
trimmed to the four trait types; Step 2 keeps the binary, count and
time-to-event phenotypes raw for its null fits, and Cox drops the
constant covariate columns and scales the rest): the transposed phenotype
file (--tpheno-file), conditioning variants joined
to the covariates (--condition-list, --condition-file), the interaction
variable E (--interaction's covariate kept apart, --interaction-snp's
variant, --interaction-prs's PRS; with the conditional mode E, and for
binary traits E^2, joined to the covariates),
--print-cov-betas and the --debug dump of the model inputs.

Mirrors the reference's run-up sequence (Data::run_step2 ->
file_read_initialization, read_pheno_and_cov, prep_run; Data.cpp:95-180,
Pheno.cpp:50-146, :1060).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .config import BT, QT, T2E, Params
from .io.files import iter_lines
from .io.geno import GenoData, open_geno
from .io.pheno import (
    PhenoData,
    convert_tpheno,
    get_basis,
    pheno_impute_miss,
    read_covariates,
    read_pheno,
    residualize_phenotypes,
    rint_values,
    set_masks,
)
from .utils.stats import chisq_neglog10, convert_logp_raw


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

    if params.transposed_pheno:
        convert_tpheno(params)
        params.transposed_pheno = False  # converted in place
        try:
            pd = read_pheno(params, sample_index, blup_pheno_names)
        finally:
            os.unlink(params.pheno_file)
    else:
        pd = read_pheno(params, sample_index, blup_pheno_names)
    new_cov, ind_in_cov, cov_names, inter = read_covariates(params, sample_index,
                                                            pd.pheno_names)
    # covariate-count log line greppable as in the reference (Pheno.cpp:642)
    log(f"n_cov = {new_cov.shape[1] - 1}")
    pd.new_cov = new_cov
    pd.interaction_cov = None
    if inter is not None:
        # the GxE covariate (--interaction), apart from the design
        pd.interaction_cov = inter[0] * ind_in_cov[:, None]
        pd.interaction_is_cat, pd.interaction_lvl_names = inter[1], inter[2]

    # conditional analysis: add conditioning variants as covariates
    # (extract_condition_snps, Pheno.cpp:940-987), mean-imputed
    if params.condition_list or params.condition_file:
        cond = _extract_condition_genotypes(params, gd)
        pd.new_cov = np.concatenate([pd.new_cov, cond], axis=1)
        log(
            f"   +conditioning on variants in [{params.condition_list}]"
            f" n_used = {cond.shape[1]}"
        )

    # GxG/GxPRS: E is extracted here, before the covariate QR, so that
    # --force-condtl can add it to the covariates (extract_interaction_snp
    # / extract_interaction_prs, Pheno.cpp:86-90); a missing interaction
    # genotype drops the individual (read_snp, Geno.cpp:3990-3994)
    if params.test_mode and (params.interaction_snp or params.interaction_prs):
        from .models.interaction import extract_interaction_E

        ind_in_cov &= extract_interaction_E(params, pd, gd, log)
    if params.gwas_condtl and pd.interaction_cov is not None:
        # conditional GWAS: E joins the covariates (Pheno.cpp:91-95)
        pd.new_cov = np.concatenate([pd.new_cov, pd.interaction_cov], axis=1)

    ind = pd.ind_in_analysis & ind_in_cov
    pd.masked_indivs &= ind[:, None]
    set_masks(params, pd, ind)
    if pd.interaction_cov is not None:
        pd.interaction_cov = pd.interaction_cov * pd.ind_in_analysis[:, None]
        if params.trait_mode == BT and params.gwas_condtl:
            # conditional BT interaction: E^2 also joins the covariates
            # (prep_run, Pheno.cpp:1073-1077)
            pd.new_cov = np.concatenate([pd.new_cov, pd.interaction_cov**2], axis=1)

    if params.apply_rint and params.trait_mode == QT:
        for j in range(params.n_pheno):
            m = (pd.phenotypes[:, j] != -999.0) & pd.masked_indivs[:, j]
            pd.phenotypes[:, j] = rint_values(pd.phenotypes[:, j], m)

    # phenotype skewness gate for --mcc (compute_skew, Pheno.cpp:117-131):
    # computed on pre-imputation values under each trait's mask
    if params.mcc_test:
        skew = np.zeros(params.n_pheno)
        for j in range(params.n_pheno):
            m = (pd.phenotypes[:, j] != -999.0) & pd.masked_indivs[:, j]
            y = pd.phenotypes[m, j]
            mu = y.mean()
            skew[j] = ((y - mu) ** 3).mean() / ((y - mu) ** 2).mean() ** 1.5
        pd.skew_Y = skew
        if params.mcc_skew == 0.0:
            pd.mcc_Y = np.ones(params.n_pheno, dtype=bool)
        else:
            pd.mcc_Y = np.abs(skew) > params.mcc_skew
            if not pd.mcc_Y.any():
                params.mcc_test = False

    pheno_impute_miss(params, pd)

    # --print-cov-betas: OLS of phenotypes on centered+scaled covariates
    # BEFORE orthonormalization (residualize_phenotypes, Pheno.cpp:1806)
    cov_betas = None
    if params.print_cov_betas and params.test_mode and params.trait_mode == QT:
        cov_betas = _cov_betas(params, pd, cov_names)

    # orthonormal covariate basis (prep_run, Pheno.cpp:1060-1117)
    if params.trait_mode == T2E:
        # Cox: drop constant covariates (incl. intercept) and center/scale
        # (prep_run T2E branch, Pheno.cpp:1080-1105; getBasis :1663-1667)
        ind = pd.ind_in_analysis
        mu = pd.new_cov[ind].mean(axis=0)
        sds = np.linalg.norm(pd.new_cov[ind] - mu[None, :], axis=0) / np.sqrt(
            params.n_analyzed)
        keep = sds > 1e-9
        pd.new_cov = (pd.new_cov[:, keep] - mu[None, keep]) / sds[None, keep]
        pd.new_cov *= ind[:, None]
    basis, ncov = get_basis(pd.new_cov, params)
    pd.new_cov = basis * pd.ind_in_analysis[:, None]
    params.ncov = ncov
    params.ncov_analyzed = ncov

    # --prs-cov: step-1 predictions enter as a covariate (check_cov_blup,
    # Pheno.cpp:1786-1797). For BTs an extra column is reserved and filled
    # per trait with the LOCO PRS during the null refits.
    if params.blup_cov and params.test_mode:
        if params.trait_mode == BT:
            pd.new_cov = np.hstack([pd.new_cov, np.zeros((pd.new_cov.shape[0], 1))])
            params.ncov = pd.new_cov.shape[1]
            params.ncov_analyzed = params.ncov
        else:
            params.ncov_analyzed = params.ncov + 1

    # --nocov-approx: only valid for a single phenotype (Pheno.cpp:1119)
    if params.skip_cov_res and params.n_pheno != 1:
        params.skip_cov_res = False
        print(" WARNING: --nocov-approx is only available with a single "
              "phenotype; ignoring it.")

    # residualize and scale the phenotypes: always for QT; binary and
    # count traits only for Step 1's level 0 (Step 2 fits them raw)
    if params.trait_mode == QT or not params.test_mode:
        residualize_phenotypes(params, pd)

    # --print-cov-betas: raw-scale covariate OLS effects per trait
    # (residualize_phenotypes + print_cov_betas, Pheno.cpp:1799/1613)
    if cov_betas is not None:
        _write_cov_betas(params, pd, *cov_betas)
    return RunData(geno=gd, pheno=pd)


def _extract_condition_genotypes(params: Params, gd) -> np.ndarray:
    """Read conditioning variants (from the main file via --condition-list,
    or an external file via --condition-file FORMAT,FILE), mean-imputed:
    [N, n_cond] on the main file's kept samples (-3 where an external
    file lacks the sample, then imputed)."""
    if params.condition_file:
        fmt_name, path = params.condition_file.split(",", 1)
        sub = Params(
            step=params.step, pheno_file=params.pheno_file,
            bed_prefix=path if fmt_name == "bed" else None,
            bgen_file=path if fmt_name == "bgen" else None,
            pgen_prefix=path if fmt_name == "pgen" else None,
            n_chrom=params.n_chrom,
            sample_file=params.condition_file_sample,
        )
        if params.condition_list:
            want = {t[0] for t in iter_lines(params.condition_list)}
        else:
            want = None
        gd2 = open_geno(sub)
        try:
            snps = [s for s in gd2.snps if want is None or s.ID in want]
            # map external samples onto main sample order by FID_IID key
            G_ext = gd2.read_block_scattered(snps).astype(np.float64)
            idx_ext = gd2.sample_index()
        finally:
            gd2.close()
        G = np.full((len(snps), gd.n_samples), -3.0)
        for j, smp in enumerate(gd.samples):
            k = idx_ext.get(smp.key)
            if k is not None:
                G[:, j] = G_ext[:, k]
    else:
        want = {t[0] for t in iter_lines(params.condition_list)}
        snps = [s for s in gd.snps if s.ID in want]
        if not snps:
            raise ValueError("no conditioning variants found in genotype file")
        G = gd.read_block_scattered(snps).astype(np.float64)
    if len(snps) > params.max_condition_vars:
        raise ValueError("too many conditioning variants")
    # mean-impute missing
    for k in range(G.shape[0]):
        m = G[k] != -3
        mu = G[k][m].mean() if m.any() else 0.0
        G[k] = np.where(m, G[k], mu)
    return G.T


def _cov_betas(params, pd, cov_names):
    """(betas, unit SEs, covariate sds, names) of the phenotypes' OLS on
    the centered and scaled covariates, or None when X'X is singular."""
    ind_b = pd.ind_in_analysis
    Xc = pd.new_cov[ind_b].copy()
    mu = Xc.mean(axis=0)
    Xc -= mu[None, :]
    Xc[:, 0] = 1.0  # keep the intercept column
    sds = np.linalg.norm(Xc, axis=0) / np.sqrt(ind_b.sum())
    ok_c = sds > params.numtol
    Xs = np.where(ok_c[None, :], Xc / np.where(ok_c, sds, 1.0)[None, :], 0.0)
    try:
        XtX_inv = np.linalg.inv(Xs.T @ Xs)
    except np.linalg.LinAlgError:
        return None
    betas = XtX_inv @ (Xs.T @ pd.phenotypes[ind_b])
    se_unit = np.sqrt(np.abs(np.diag(XtX_inv)))
    return betas, se_unit, np.where(ok_c, sds, 0.0), cov_names


def _write_cov_betas(params, pd, betas, se_unit, cov_sds, cov_names):
    """{out}_cov_betas.txt: COVAR PHENO BETA SE PVALUE rows."""
    path = params.out_prefix + "_cov_betas.txt"
    with open(path, "w") as fh:
        fh.write("COVAR\tPHENO\tBETA\tSE\tPVALUE\n")
        for ic, cname in enumerate(cov_names):
            for ph, pname in enumerate(pd.pheno_names):
                if not pd.pheno_pass[ph] or cov_sds[ic] <= 0:
                    fh.write(f"{cname}\t{pname}\tNA\tNA\tNA\n")
                    continue
                b = betas[ic, ph] / cov_sds[ic]
                se = se_unit[ic] * pd.scale_Y[ph] / cov_sds[ic]
                if se <= 0:
                    fh.write(f"{cname}\t{pname}\tNA\tNA\tNA\n")
                    continue
                stat = (betas[ic, ph] / (se_unit[ic] * pd.scale_Y[ph])) ** 2
                logp = float(chisq_neglog10(np.array([stat]))[0])
                fh.write(f"{cname}\t{pname}\t{fmt(b)}\t{fmt(se)}\t"
                         f"{convert_logp_raw(logp)}\n")


def write_debug_inputs(params: Params, pd, offsets=None) -> None:
    """--debug analog of write_inputs (Data.cpp:911): the model inputs
    after prep, Y ({out}_y.txt: residualized and scaled for QT, raw for
    the other traits), the orthonormal covariate basis ({out}_x.txt) and,
    where a null fit gives them (Step 1 on binary, count and
    time-to-event traits), the null offsets ({out}_offset.txt), at full
    precision and space-separated (the reference's Eigen FullPrecision
    format)."""
    y = pd.phenotypes if params.trait_mode == QT else pd.phenotypes_raw
    if y is not None:
        np.savetxt(params.out_prefix + "_y.txt", np.asarray(y), fmt="%.17g")
    np.savetxt(params.out_prefix + "_x.txt", np.asarray(pd.new_cov),
               fmt="%.17g")
    if offsets is not None:
        np.savetxt(params.out_prefix + "_offset.txt", np.asarray(offsets),
                   fmt="%.17g")


def fmt(x: float) -> str:
    """C++ default ostream formatting (6 significant digits, %g rules)."""
    if isinstance(x, (float, np.floating)) and np.isnan(x):
        return "nan"
    return f"{x:g}"
