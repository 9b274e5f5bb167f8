"""Command-line interface of the port: `python -m regenie_tpu_torch`
takes the same flags as `python -m regenie_tpu` (the reference's flag
surface, src/Regenie.cpp:146-458). build_parser and args_to_params are
the port's copies of regenie_tpu/cli.py's; main runs the modes the port
has (Step 1 and Step 2 on quantitative, binary, count and time-to-event
traits; Step 2's gene-based, interaction, multi-trait, MultiPhen and MCC
tests and LD mode; on PLINK BED, PGEN and BGEN, in one process) and
raises NotImplementedError for every other one (unported).

The device is CUDA unless REGENIE_TPU_TORCH_DEVICE=cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from typing import List, Optional

import numpy as np

from . import __version__
from .config import BT, CT, QT, T2E, Params


def _split_list(s: str) -> List[str]:
    out = []
    for tok in s.split(","):
        # brace expansion {i:j} (Regenie.cpp:1743-1760)
        m = re.match(r"^(.*)\{(\d+):(\d+)\}(.*)$", tok)
        if m:
            pre, lo, hi, post = m.group(1), int(m.group(2)), int(m.group(3)), m.group(4)
            out.extend(f"{pre}{i}{post}" for i in range(lo, hi + 1))
        else:
            out.append(tok)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="regenie_tpu_torch",
        description="PyTorch/CUDA whole-genome regression (capabilities of regenie v4.1)",
    )
    g = p.add_argument_group("Main options")
    g.add_argument("--step", type=int, required=True, help="specify if fitting null model (=1) or association testing (=2)")
    g.add_argument("--bed", help="prefix to PLINK .bed/.bim/.fam files")
    g.add_argument("--pgen", help="prefix to PLINK2 .pgen/.pvar/.psam files")
    g.add_argument("--bgen", help="BGEN file")
    g.add_argument("--sample", help="sample file for BGEN")
    g.add_argument("--bgi", default=None, help=".bgi index file for the BGEN")
    g.add_argument("--ref-first", action="store_true", help="first allele is the reference")
    g.add_argument("--keep", action="append", default=[], help="file of samples to keep")
    g.add_argument("--remove", action="append", default=[], help="file of samples to remove")
    g.add_argument("--extract", action="append", default=[], help="file of variant IDs to keep")
    g.add_argument("--exclude", action="append", default=[], help="file of variant IDs to remove")
    g.add_argument("--force-mac-filter", default=None, metavar="snpfile,MAC",
                   help="separate MAC filter for a subset of variants")
    g.add_argument("--extract-or", action="append", default=[],
                   help="variants kept regardless of the MAC filter")
    g.add_argument("--exclude-or", action="append", default=[],
                   help="variants MAC-filtered; all others pass regardless")
    g.add_argument("--phenoFile", default=None, help="phenotype file")
    g.add_argument("--tpheno-file", default=None,
                   help="transposed phenotype file (each row is a phenotype)")
    g.add_argument("--tpheno-indexCol", type=int, default=1)
    g.add_argument("--tpheno-ignoreCols", default=None,
                   help="comma-separated 1-based column indexes to ignore ({i:j} ranges)")
    g.add_argument("--iid-only", action="store_true",
                   help="transposed pheno header contains IID only")
    g.add_argument("--phenoCol", action="append", default=[], help="phenotype column to include")
    g.add_argument("--phenoColList", default=None, help="comma-separated phenotype columns")
    g.add_argument("--phenoExcludeList", default=None,
                   help="comma-separated phenotype columns to drop")
    g.add_argument("--covarFile", help="covariate file")
    g.add_argument("--covarCol", action="append", default=[])
    g.add_argument("--covarColList", default=None,
                   help="comma-separated covariate columns to keep ({i:j} expansion)")
    g.add_argument("--catCovarList", default=None, help="categorical covariates")
    g.add_argument("--covarExcludeList", default=None,
                   help="comma-separated covariate columns to drop")
    g.add_argument("--maxCatLevels", type=int, default=10)
    g.add_argument("--qt", action="store_true", help="quantitative traits (default)")
    g.add_argument("--bt", action="store_true", help="binary traits")
    g.add_argument("--ct", action="store_true", help="count traits (Poisson)")
    g.add_argument("--t2e", action="store_true", help="time-to-event traits (Cox)")
    g.add_argument("--eventColList", default=None, help="event status columns (paired with --phenoColList)")
    g.add_argument("--coxscore-exact", action="store_true",
                   help="exact (risk-set) score variance for Cox tests")
    g.add_argument("--coxnofirth", action="store_true",
                   help="plain Cox LRT instead of the Firth-penalized one")
    g.add_argument("--compute-corr", action="store_true", help="compute LD matrix")
    g.add_argument("--ld-extract", default=None,
                   help="file listing variants (sv) and masks for the LD matrix")
    g.add_argument("--output-corr-text", action="store_true",
                   help="write the LD matrix as text instead of binary")
    g.add_argument("--skip-scaleG", action="store_true",
                   help="unscaled G'G in LD-matrix mode (covariance, not correlation)")
    g.add_argument("--sparse-thr", type=float, default=None,
                   help="threshold used to sparsify the LD matrix")
    g.add_argument("--condition-list", default=None, help="file with variant IDs to condition on")
    g.add_argument("--condition-file", default=None, help="FORMAT,FILE with conditioning variants")
    g.add_argument("--interaction", default=None, help="covariate for GxE interaction test")
    g.add_argument("--interaction-snp", default=None, help="variant for GxG interaction test")
    g.add_argument("--interaction-file", default=None,
                   help="FORMAT,FILE external genotype file for the interaction SNP")
    g.add_argument("--interaction-file-reffirst", action="store_true",
                   help="alleles in --interaction-file are ref-first coded")
    g.add_argument("--force-condtl", action="store_true",
                   help="condition on the interacting variable in the marginal GWAS")
    g.add_argument("--no-condtl", action="store_true",
                   help="print all main effects in the GxE interaction test")
    g.add_argument("--interaction-prs", action="store_true",
                   help="interaction testing with the full step-1 PRS")
    g.add_argument("--print-vcov", action="store_true",
                   help="write coefficient covariance per tested variant (interaction)")
    g.add_argument("--rare-mac", type=float, default=1000.0)
    g.add_argument("--force-robust", action="store_true",
                   help="HC3 robust SEs for rare-variant GxE instead of HLM")
    g.add_argument("--force-robust-hc4", "--force-hc4", dest="force_robust_hc4",
                   action="store_true",
                   help="HC4 robust SEs for the rare-variant GxE QT test")
    g.add_argument("--no-robust", action="store_true",
                   help="model-based SEs for all interaction tests")
    g.add_argument("--1", "--cc12", dest="cc12", action="store_true", help="1/2/NA coding")
    g.add_argument("--out", "-o", required=True, help="output file prefix")
    g.add_argument("--bsize", "-b", type=int, default=1000, help="block size")
    g.add_argument("--cv", type=int, default=5, help="number of CV folds")
    g.add_argument("--loocv", action="store_true", help="use LOOCV")
    g.add_argument("--l0", type=int, default=5, help="number of level-0 ridge params")
    g.add_argument("--l1", type=int, default=5, help="number of level-1 ridge params")
    g.add_argument("--setl0", default=None, help="comma-separated level-0 h2 grid in (0,1)")
    g.add_argument("--setl1", default=None, help="comma-separated level-1 h2 grid in (0,1)")
    g.add_argument("--lowmem", action="store_true", help="reduce memory usage")
    g.add_argument("--lowmem-prefix", default=None,
                   help="scratch-file prefix for --lowmem level-0 spills")
    g.add_argument("--split-l0", default=None, help="PREFIX,N : split level 0 into N jobs")
    g.add_argument("--run-l0", default=None, help="MASTER,i : run level 0 job i")
    g.add_argument("--run-l1", default=None, help="MASTER : run level 1")
    g.add_argument("--l1-phenoList", default=None,
                   help="comma-separated traits to run level 1 for (with --run-l1)")
    g.add_argument("--keep-l0", action="store_true",
                   help="keep the binary level-0 prediction files after --run-l1")
    g.add_argument("--test-l0", action="store_true",
                   help="extract highly-associated SNPs before level-0 ridge")
    g.add_argument("--l0-pval-thr", type=float, default=-1.0)
    g.add_argument("--strict", action="store_true",
                   help="drop samples with any missing phenotype (shared mask)")
    g.add_argument("--print-prs", action="store_true",
                   help="also write whole-genome PRS files (_prs.list)")
    g.add_argument("--gz", action="store_true", help="gzip output files")
    g.add_argument("--apply-rint", action="store_true",
                   help="rank-inverse-normal transform quantitative traits")
    g.add_argument("--apply-rerint", action="store_true",
                   help="RINT the residualized QTs in step 2")
    g.add_argument("--apply-rerint-cov", action="store_true",
                   help="RINT residualized QTs then re-project covariates")
    g.add_argument("--minHOMs", type=float, default=0.0,
                   help="min hom-ALT carriers for the recessive test")
    g.add_argument("--minCaseCount", type=int, default=10,
                   help="minimum number of cases per binary trait")
    g.add_argument("--threads", type=int, default=0)
    g.add_argument("--nauto", type=int, default=22, help="number of autosomes")
    g.add_argument("--seed", type=int, default=1, help="RNG seed (SBAT MC weights)")
    g.add_argument("--nostream", action="store_true", help="no-op (streaming always on)")
    g.add_argument("--force-impute", action="store_true",
                   help="keep+impute missing QT observations in step 2")
    g.add_argument("--t-test", action="store_true",
                   help="t-distribution p-values for quantitative traits")
    g.add_argument("--compute-all", action="store_true",
                   help="store null Firth estimates for all chromosomes")
    g.add_argument("--mse-full", action="store_true",
                   help="use full-model MSE for the QT score-test variance")
    g.add_argument("--prior-alpha", type=float, default=-1.0,
                   help="alpha for the MAF-dependent prior on SNP effects (step 1)")
    g.add_argument("--nocov-approx", action="store_true",
                   help="skip adjusting genotypes for covariates in the score test")
    g.add_argument("--forcein-vars", action="store_true",
                   help="retain --extract variants absent from the genotype file "
                        "in the LD matrix")
    g.add_argument("--prs-cov", action="store_true",
                   help="include step-1 predictions as a covariate rather than offset")
    g.add_argument("--l1-full", action="store_true",
                   help="use all samples for the final L1 logistic-LOOCV model")
    g.add_argument("--print", dest="print_block_betas", action="store_true",
                   help="print estimated effect sizes from level 0 and level 1 models")
    g.add_argument("--t2e-event-l0", action="store_true",
                   help="use event status as the level-0 response for T2E traits")
    g.add_argument("--t2e-l1-pi6", action="store_true",
                   help="heritability-based (pi^2/6) penalty grid for the T2E level 1")
    g.add_argument("--select-l0", nargs="?", const="", default=None, metavar="FILE",
                   help="file with p-values for each level-0 block "
                        "(use as a flag with --test-l0)")
    g.add_argument("--rm-l0-pct", type=float, default=0.0,
                   help="remove the least x%% significant blocks from level-1 models")
    g.add_argument("--within", action="store_true",
                   help="accepted no-op (disabled upstream: within-sample L0 predictions)")
    g.add_argument("--l0-event", action="store_true",
                   help="accepted no-op (upstream parameter is never read)")
    g.add_argument("--helpFull", action="help",
                   help="print usage for all options")
    g.add_argument("--version", action="version",
                   version="regenie-tpu-torch v" + __version__,
                   help="print version number and exit")
    g.add_argument("--hlm-novquad", action="store_true",
                   help="use Var(y)=sigma^2*exp(b0+b1*E) in the HLM "
                        "(i.e. no quadratic E^2 term in the variance model)")
    g.add_argument("--skip-fast-firth", action="store_true",
                   help="accepted; the exact Newton solver is always used")
    g.add_argument("--skip-cf-burden", action="store_true",
                   help="skip computing the per-mask calibration factor "
                        "for SKAT/SKATO tests with Firth/SPA correction")
    g.add_argument("--exact-p", action="store_true",
                   help="uncapped p-values in HTP output")
    g.add_argument("--skip-test", action="store_true",
                   help="build masks without running association tests")
    g.add_argument("--use-relative-path", action="store_true",
                   help="relative paths in the step-1 pred.list")
    g.add_argument("--htp-with-event", action="store_true",
                   help="use the event name in the HTP Trait column (T2E)")
    g.add_argument("--early-exit", action="store_true",
                   help="exit after fitting level-0 models")
    g.add_argument("--use-adam", action="store_true",
                   help="run an ADAM pre-pass before every level-1 logistic "
                        "ridge Newton solve (ADAM is also the automatic "
                        "non-convergence fallback)")
    g.add_argument("--adam-mini", action="store_true",
                   help="use 128-row mini-batches in the ADAM pre-pass")
    g.add_argument("--prop-zero-thr", type=float, default=None, help="accepted no-op (dense device path)")
    g.add_argument("--condition-file-sample", default=None,
                   help="sample file for the --condition-file BGEN")
    g.add_argument("--interaction-file-sample", default=None,
                   help="sample file for the --interaction-file BGEN")
    g.add_argument("--pred", help="_pred.list file from step 1")
    g.add_argument("--ignore-pred", action="store_true",
                   help="skip the step-1 LOCO predictions (plain GWAS)")
    g.add_argument("--use-prs", action="store_true",
                   help="use whole-genome PRS in --pred (no LOCO)")
    g.add_argument("--force-ltco", type=int, default=None,
                   help="leave-two-chromosome-out: extra chromosome excluded from LOCO")
    g.add_argument("--write-samples", action="store_true",
                   help="write analyzed sample IDs per trait (*.regenie.ids)")
    g.add_argument("--print-pheno", action="store_true",
                   help="print phenotype name on the first line of .ids files")
    g.add_argument("--print-cov-betas", action="store_true",
                   help="print covariate effects to file (step 2, QT)")
    g.add_argument("--minMAC", type=float, default=5.0)
    g.add_argument("--minINFO", type=float, default=None,
                   help="minimum imputation INFO score (dosage data)")
    g.add_argument("--no-split", dest="no_split", action="store_true", help="single output file for all traits")
    g.add_argument("--firth", action="store_true",
                   help="Firth-corrected LRT fallback for rare/unbalanced BTs")
    g.add_argument("--approx", action="store_true",
                   help="approximate Firth (null covariate effects fixed; ~60x faster)")
    g.add_argument("--firth-se", action="store_true",
                   help="SE from the Firth LRT (|beta|/sqrt(LRT)) in outputs")
    g.add_argument("--spa", action="store_true",
                   help="saddlepoint-approximation fallback for BT score tests")
    g.add_argument("--par-region", default="hg38",
                   help="build code for chrX PAR bounds (b36/b37/b38/hg18/hg19/hg38 or start,end)")
    g.add_argument("--skip-dosage-comp", action="store_true",
                   help="no dosage compensation for chrX non-PAR males")
    g.add_argument("--mt", action="store_true", help="run multi-trait tests")
    g.add_argument("--multiphen", action="store_true",
                   help="MultiPhen reverse-ordinal multi-trait test")
    g.add_argument("--multiphen-thr", type=float, default=0.001)
    g.add_argument("--multiphen-tol", type=float, default=2.5e-4)
    g.add_argument("--multiphen-firth-mult", type=float, default=1.0)
    g.add_argument("--multiphen-maxstep", type=float, default=200.0)
    g.add_argument("--multiphen-maxit", type=int, default=150)
    g.add_argument("--multiphen-test", default="nocov_score_offset",
                   help="strategy: nocov_score, cov_score, nocov_lrt, "
                        "cov_lrt, nocov_score_offset (score then LRT "
                        "escalation; default), none")
    g.add_argument("--multiphen-optim", default="WeightHalvingPseudo",
                   help="accepted; damped Newton is used")
    g.add_argument("--multiphen-trace", action="store_true", help="accepted no-op")
    g.add_argument("--multiphen-verbose", type=int, default=0, help="accepted no-op")
    g.add_argument("--multiphen-strict", action="store_true", help="accepted no-op")
    g.add_argument("--multiphen-offset", default="offset_int", help="accepted no-op")
    g.add_argument("--multiphen-approx-offset", type=int, default=-1,
                   help="freeze covariate effects as a null-fit offset in "
                        "the MultiPhen LRT full model: -1/0 never, 1 always, "
                        ">1 when the minor genotype-category count exceeds it")
    g.add_argument("--multiphen-maxit2", type=int, default=5, help="accepted no-op")
    g.add_argument("--multiphen-pseudo-stophalf", type=float, default=0.0,
                   help="accepted no-op")
    g.add_argument("--multiphen-reset-start", action="store_true",
                   help="accepted no-op")
    g.add_argument("--mcc", action="store_true", help="MCC (DKAT) test for skewed QTs")
    g.add_argument("--mcc-skew", type=float, default=0.0)
    g.add_argument("--mcc-thr", type=float, default=0.01)
    g.add_argument("--pThresh", type=float, default=0.05)
    g.add_argument("--test", choices=["additive", "dominant", "recessive"], default="additive")
    g.add_argument("--chr", action="append", default=[])
    g.add_argument("--chrList", default=None,
                   help="comma-separated chromosomes to test")
    g.add_argument("--range", default=None, help="CHR:MINPOS-MAXPOS variant window")
    g.add_argument("--sex-specific", default=None, choices=["male", "female"],
                   help="restrict the analysis to one sex")
    g.add_argument("--htp", default=None, help="cohort name for HTPv4 output")
    g.add_argument("--af-cc", action="store_true",
                   help="report case/control AFs separately (A1FREQ_CASES/_CONTROLS)")
    g.add_argument("--force-step1", action="store_true",
                   help="allow >1M variants in step 1")
    g.add_argument("--force-qt", action="store_true",
                   help="treat non-binary-looking numeric traits as quantitative")
    g.add_argument("--nb", type=int, default=None,
                   help="number of blocks (step-2 resume bookkeeping)")
    g.add_argument("--starting-block", type=int, default=1)
    g.add_argument("--niter", type=int, default=30)
    g.add_argument("--maxiter-null", type=int, default=1000)
    g.add_argument("--maxstep-null", type=int, default=25)
    g.add_argument("--write-null-firth", action="store_true",
                   help="checkpoint per-chromosome null Firth coefficients")
    g.add_argument("--use-null-firth", default=None,
                   help="reuse a _firth.list checkpoint of null Firth coefficients")
    g.add_argument("--verbose", "-v", action="store_true", help="verbose screen output")
    g.add_argument("--debug", action="store_true",
                   help="debug output (implies --verbose)")

    gb = p.add_argument_group("Gene-based tests")
    gb.add_argument("--set-list", default=None, help="set list file (gene sets)")
    gb.add_argument("--anno-file", default=None, help="variant annotation file")
    gb.add_argument("--anno-labels", default=None, help="annotation labels file")
    gb.add_argument("--mask-def", default=None, help="mask definition file")
    gb.add_argument("--aaf-bins", default=None, help="comma-separated AAF cutoffs")
    gb.add_argument("--build-mask", default="max", choices=["max", "sum", "comphet"])
    gb.add_argument("--singleton-carrier", action="store_true",
                    help="define singletons by carrier count (not MAC=1)")
    gb.add_argument("--set-singletons", action="store_true",
                    help="0/1 indicator in AAF-file col 3 marks singletons")
    gb.add_argument("--write-mask", action="store_true",
                    help="write built burden masks as PLINK bed")
    gb.add_argument("--write-mask-snplist", action="store_true",
                    help="write the variants entering each mask")
    gb.add_argument("--write-setlist", default=None,
                    help="config file to write set-lists of built masks")
    gb.add_argument("--check-burden-files", action="store_true",
                    help="consistency report across set-list/anno/mask files")
    gb.add_argument("--strict-check-burden", action="store_true",
                    help="abort if the burden-file consistency check fails")
    gb.add_argument("--aaf-file", default=None,
                    help="file with alternate-allele frequencies for AAF bins")
    gb.add_argument("--extract-sets", default=None,
                    help="file of set names to keep")
    gb.add_argument("--exclude-sets", default=None,
                    help="file of set names to drop")
    gb.add_argument("--extract-setlist", default=None,
                    help="comma-separated set names to keep")
    gb.add_argument("--exclude-setlist", default=None,
                    help="comma-separated set names to drop")
    gb.add_argument("--vc-tests", default=None, help="skat,skato,skato-acat,acatv,acato,acato-full")
    gb.add_argument("--vc-maxAAF", type=float, default=1.0)
    gb.add_argument("--vc-MACthr", type=float, default=10.0)
    gb.add_argument("--skat-params", default=None, metavar="A1,A2",
                    help="Beta(A1,A2) weight parameters for VC tests")
    gb.add_argument("--skato-rho", default=None,
                    help="comma-separated rho grid for SKATO")
    gb.add_argument("--acat-beta", default=None, metavar="A1,A2",
                    help="Beta parameters for ACAT weights")
    gb.add_argument("--sbat-napprox", type=int, default=10,
                    help="number of sampled active sets per approximated "
                         "SBAT chi-bar weight")
    gb.add_argument("--sbat-adapt", action="store_true",
                    help="adaptive SBAT: cheap k=2 weights first, full "
                         "accuracy only when p < 1e-3")
    gb.add_argument("--sbat-mtw", action="store_true",
                    help="re-use SBAT weights across all traits")
    gb.add_argument("--sbat-verbose", action="store_true",
                    help="also write the one-sided SBAT_POS/SBAT_NEG rows")
    gb.add_argument("--joint-only", action="store_true",
                    help="only print joint-test results")
    gb.add_argument("--max-condition-vars", type=int, default=10000)
    gb.add_argument("--joint", default=None, help="minp,acat,ftest,gates,sbat,gene_p")
    gb.add_argument("--weights-col", type=int, default=0,
                    help="1-based annotation-file column with VC weights")
    gb.add_argument("--multiply-weights", action="store_true",
                    help="multiply user AAF-file weights with the Beta(1,25) weights")
    gb.add_argument("--remeta-save-ld", action="store_true",
                    help="store SKAT LD matrices for remeta")
    gb.add_argument("--remeta-ld-spr", type=float, default=0.01)
    gb.add_argument("--rgc-gene-p", action="store_true",
                    help="optimal strategy for a single p-value per gene")
    gb.add_argument("--rgc-gene-def", default=None,
                    help="file with mask groups for the GENE_P strategy")
    gb.add_argument("--skip-sbat", action="store_true",
                    help="drop SBAT from the GENE_P combination")
    gb.add_argument("--mask-lovo", default=None,
                    help="leave-one-variant-out masks: gene,mask,aaf-bin")
    gb.add_argument("--lovo-snplist", default=None,
                    help="variants to generate LOVO masks for")
    gb.add_argument("--mask-lodo", default=None, metavar="STRING",
                    help="apply Leave-One-Domain-Out (LODO) scheme when "
                    "building masks (<set_name>,<mask_name>,<aaf_cutoff>)")
    return p


def args_to_params(args: argparse.Namespace) -> Params:
    params = Params()
    params.step = args.step
    params.test_mode = args.step == 2
    if args.bt:
        params.trait_mode = BT
    elif args.ct:
        params.trait_mode = CT
    elif args.t2e:
        params.trait_mode = T2E
    params.bed_prefix = args.bed
    params.pgen_prefix = args.pgen
    params.bgen_file = args.bgen
    params.sample_file = args.sample
    params.bgi_file = args.bgi
    params.ref_first = args.ref_first
    if args.tpheno_file:
        params.pheno_file = args.tpheno_file
        params.transposed_pheno = True
        params.tpheno_index_col = args.tpheno_indexCol
        params.tpheno_iid_only = args.iid_only
        if args.tpheno_ignoreCols:
            cols = []
            for tok in args.tpheno_ignoreCols.split(","):
                if ":" in tok:  # {i:j} parameter expansion
                    a, b = tok.strip("{}").split(":")
                    cols.extend(range(int(a), int(b) + 1))
                else:
                    cols.append(int(tok.strip("{}")))
            params.tpheno_ignore_cols = cols
    elif args.phenoFile:
        params.pheno_file = args.phenoFile
    else:
        raise SystemExit("ERROR: provide --phenoFile or --tpheno-file")
    params.cov_file = args.covarFile
    params.out_prefix = args.out
    params.pred_list = args.pred
    params.skip_blups = args.ignore_pred
    params.use_prs = args.use_prs
    if args.force_ltco is not None:
        if args.use_prs:
            raise SystemExit("ERROR: cannot use --force-ltco with --use-prs")
        params.ltco_chr = args.force_ltco
    params.print_prs = args.print_prs

    pheno_cols = list(args.phenoCol)
    if args.phenoColList:
        pheno_cols += _split_list(args.phenoColList)
    params.pheno_cols = pheno_cols
    if args.phenoExcludeList:
        params.pheno_cols_rm = _split_list(args.phenoExcludeList)
    cov_cols = list(args.covarCol)
    if args.covarColList:
        cov_cols += _split_list(args.covarColList)
    params.cov_cols = cov_cols
    if args.catCovarList:
        params.cat_cov_cols = _split_list(args.catCovarList)
    if args.covarExcludeList:
        params.cov_cols_rm = _split_list(args.covarExcludeList)
    params.max_cat_levels = args.maxCatLevels
    params.cc12 = args.cc12
    params.strict_mode = args.strict
    params.apply_rint = args.apply_rint
    if not args.bt:
        params.rerint = args.apply_rerint
        params.rerint_cov = args.apply_rerint_cov
    params.min_homs = args.minHOMs
    params.min_case_count = args.minCaseCount
    params.uncapped_pvals = args.exact_p
    if args.force_impute:
        params.rm_missing_qt = False
    params.t_test = args.t_test
    params.alpha_prior = args.prior_alpha
    params.skip_cov_res = args.nocov_approx
    params.blup_cov = args.prs_cov
    params.l1_full_samples = args.l1_full and args.bt and args.loocv
    params.print_block_betas = args.print_block_betas
    params.t2e_event_l0 = args.t2e_event_l0
    params.t2e_l1_pi6 = args.t2e_l1_pi6
    params.mse_full = args.mse_full
    params.rm_l0_pct = args.rm_l0_pct
    if args.select_l0 is not None:
        params.select_l0 = True
        params.l0_pvals_file = args.select_l0 or None
    if args.rm_l0_pct and not (args.select_l0 is not None or args.test_l0):
        raise SystemExit("ERROR: --rm-l0-pct requires --select-l0 or --test-l0")
    params.compute_all_chr = args.compute_all
    params.skip_test = args.skip_test
    params.use_rel_path = args.use_relative_path
    params.htp_use_eventname = args.htp_with_event
    params.early_exit = args.early_exit
    params.condition_file_sample = args.condition_file_sample
    params.interaction_file_sample = args.interaction_file_sample

    params.keep_files = args.keep
    params.remove_files = args.remove
    params.extract_files = args.extract
    params.exclude_files = args.exclude
    params.extract_or_files = args.extract_or
    params.exclude_or_files = args.exclude_or
    if args.force_mac_filter:
        fparts = args.force_mac_filter.split(",")
        if len(fparts) != 2:
            raise SystemExit("ERROR: --force-mac-filter expects snpfile,MAC")
        params.forced_mac_snpfile = fparts[0]
        params.forced_mac = float(fparts[1])

    params.block_size = args.bsize
    params.cv_folds = args.cv
    params.use_loocv = args.loocv
    params.n_ridge_l0 = args.l0
    params.n_ridge_l1 = args.l1
    # user ridge h2 grids (get_unit_params, Regenie.cpp:846-860)
    for flagval, attr, nattr in ((args.setl0, "user_lambda", "n_ridge_l0"),
                                 (args.setl1, "user_tau", "n_ridge_l1")):
        if flagval:
            vals = np.array([float(x) for x in flagval.split(",")])
            if ((vals <= 0) | (vals >= 1)).any():
                raise SystemExit("ERROR: ridge parameters must be in (0,1)")
            setattr(params, attr, vals)
            setattr(params, nattr, len(vals))
    params.write_l0_pred = args.lowmem
    params.loco_tmp_prefix = args.lowmem_prefix
    params.split_l0 = args.split_l0
    params.run_l0 = args.run_l0
    params.run_l1 = args.run_l1
    if args.l1_phenoList:
        if not args.run_l1:
            raise SystemExit("ERROR: --l1-phenoList requires --run-l1")
        params.select_pheno_l1 = _split_list(args.l1_phenoList)
    params.keep_l0 = args.keep_l0
    params.test_l0 = args.test_l0
    params.l0_snp_pval_thr = args.l0_pval_thr
    if params.test_l0 and args.run_l0:
        raise SystemExit("ERROR: cannot use --test-l0 with --run-l0")
    if params.test_l0 and params.print_block_betas:
        raise SystemExit("ERROR: cannot use --test-l0 with --print")
    params.print_prs = args.print_prs
    params.gz_out = args.gz
    params.force_step1 = args.force_step1
    params.niter_max_ridge = args.niter
    params.niter_max_firth_null = args.maxiter_null
    params.maxstep_null = args.maxstep_null

    params.min_mac = args.minMAC
    if args.minINFO is not None:
        params.min_info = args.minINFO
        params.set_min_info = True
    params.firth = args.firth
    params.firth_approx = args.firth and args.approx
    params.use_spa = args.spa
    # only meaningful with Firth/SPA; silently dropped otherwise
    # (Regenie.cpp:1140-1141)
    params.skip_cf_burden = args.skip_cf_burden and (args.spa or args.firth)
    # chrX PAR bounds (check_build_code, Regenie.cpp:1643-1660)
    params.build_code = args.par_region
    bc = args.par_region
    if bc in ("b36", "hg18"):
        params.par1_max_bound, params.par2_min_bound = 2709520, 154584238
    elif bc in ("b37", "hg19"):
        params.par1_max_bound, params.par2_min_bound = 2699520, 154931044
    elif bc in ("b38", "hg38"):
        params.par1_max_bound, params.par2_min_bound = 2781479, 155701383
    else:
        try:
            lo, hi = (int(x) for x in bc.split(","))
        except ValueError:
            raise SystemExit(f"ERROR: invalid --par-region '{bc}'")
        if lo < 1 or hi < lo:
            raise SystemExit(f"ERROR: invalid --par-region '{bc}'")
        params.par1_max_bound, params.par2_min_bound = lo - 1, hi + 1
    params.skip_dosage_comp = args.skip_dosage_comp
    if params.skip_dosage_comp and args.test != "additive":
        raise SystemExit("ERROR: cannot use --skip-dosage-comp with --test.")
    params.multiphen = args.multiphen
    if params.multiphen:
        if not args.strict:
            raise SystemExit("ERROR: --strict mode is required for MultiPhen test")
        if not (0 < args.multiphen_thr <= 1):
            raise SystemExit("ERROR: --multiphen-thr must be in (0; 1]")
        params.multiphen_thr = args.multiphen_thr
        params.multiphen_tol = args.multiphen_tol
        params.multiphen_firth_mult = args.multiphen_firth_mult
        params.multiphen_maxstep = args.multiphen_maxstep
        params.multiphen_maxit = args.multiphen_maxit
        params.multiphen_approx_offset = args.multiphen_approx_offset
        params.multiphen_test = args.multiphen_test
    params.trait_set = args.mt
    if params.trait_set:
        # Regenie.cpp:1255-1260: strict + merged output required
        if not args.strict:
            raise SystemExit("ERROR: --strict mode is required for multi-trait tests")
        if not args.no_split:
            raise SystemExit("ERROR: --no-split mode is required for multi-trait tests")
    params.mcc_test = args.mcc
    params.mcc_skew = args.mcc_skew
    if params.mcc_skew < 0:
        raise SystemExit("ERROR: absolute phenotypic skewness must be positive")
    if params.mcc_skew > 0 and not params.mcc_test:
        raise SystemExit("ERROR: --mcc must be on when specifying --mcc-skew")
    if params.mcc_test:
        # Regenie.cpp:1270-1276: thr < 1 gates MCC behind the score test
        if not (0 < args.mcc_thr <= 1):
            raise SystemExit("ERROR: --mcc-thr must be in (0; 1]")
        params.mcc_thr = args.mcc_thr
        params.mcc_apply_thr = params.mcc_thr < 1
        params.mcc_thr_nlog10 = -np.log10(params.mcc_thr)
    params.alpha_pvalue = args.pThresh
    params.split_by_pheno = not args.no_split
    params.htp_out = args.htp is not None
    if args.htp:
        params.cohort_name = args.htp
    params.af_cc = args.af_cc
    params.write_samples = args.write_samples
    params.print_pheno_name = args.print_pheno
    params.print_cov_betas = args.print_cov_betas
    if params.print_cov_betas:
        if args.interaction or args.interaction_snp:
            raise SystemExit("ERROR: cannot use --print-cov-betas with interaction tests")
        if args.step != 2:
            raise SystemExit("ERROR: can only use --print-cov-betas in step 2")
    params.test_type = {"additive": 0, "dominant": 1, "recessive": 2}[args.test]
    chrs = list(args.chr)
    if args.chrList:
        chrs += _split_list(args.chrList)
    params.chr_list = chrs
    params.range_spec = args.range
    if args.range:
        # CHR:MINPOS-MAXPOS (Regenie.cpp:745-754)
        import re as _re

        m = _re.fullmatch(r"([^:]+):([\d.eE+]+)-([\d.eE+]+)", args.range)
        if not m:
            raise SystemExit("ERROR: wrong format for --range (must be CHR:MINPOS-MAXPOS)")
        from .io.bed import chr_to_int

        params.range_chr = chr_to_int(m.group(1))
        p0, p1 = float(m.group(2)), float(m.group(3))
        params.range_min, params.range_max = min(p0, p1), max(p0, p1)
        if params.range_chr == -1:
            raise SystemExit("ERROR: invalid chromosome in --range")
    if args.sex_specific:
        params.sex_specific = 1 if args.sex_specific == "male" else 2
    params.nb = args.nb
    params.starting_block = args.starting_block
    params.write_null_firth = args.write_null_firth
    params.use_null_firth = args.use_null_firth
    params.verbose = args.verbose
    params.debug = args.debug

    # gene-based tests
    params.set_list = args.set_list
    params.anno_file = args.anno_file
    params.anno_labels_file = args.anno_labels
    params.mask_def = args.mask_def
    if args.aaf_bins:
        params.aaf_bins = _split_list(args.aaf_bins)
    params.mask_rule = args.build_mask
    params.build_mask = params.set_list is not None and params.mask_def is not None
    params.singleton_carriers = args.singleton_carrier
    params.write_masks = args.write_mask
    params.write_mask_snplist = args.write_mask_snplist
    params.write_setlist = args.write_setlist
    params.check_burden_files = args.check_burden_files
    params.set_aaf_file = args.aaf_file
    params.aaf_file_wSingletons = bool(args.aaf_file and args.set_singletons)
    params.extract_sets = args.extract_sets
    params.exclude_sets = args.exclude_sets
    if args.extract_setlist:
        params.extract_setlist = _split_list(args.extract_setlist)
    if args.exclude_setlist:
        params.exclude_setlist = _split_list(args.exclude_setlist)
    if args.vc_tests:
        params.vc_tests = [t.lower() for t in _split_list(args.vc_tests)]
    params.vc_maxAAF = args.vc_maxAAF
    params.skat_collapse_MAC = args.vc_MACthr
    params.n_chrom = args.nauto + 1
    params.seed = args.seed
    params.sbat_napprox = args.sbat_napprox
    params.sbat_adapt = args.sbat_adapt
    params.sbat_mtw = args.sbat_mtw
    params.sbat_verbose = args.sbat_verbose
    params.use_adam = args.use_adam
    params.adam_mini = args.adam_mini
    params.max_condition_vars = args.max_condition_vars
    params.p_joint_only = args.joint_only
    if args.skat_params:
        a1, a2 = (float(x) for x in args.skat_params.split(","))
        params.skat_a1, params.skat_a2 = a1, a2
    if args.skato_rho:
        params.skato_rho = np.array([float(x) for x in args.skato_rho.split(",")])
        params.skato_rho = np.minimum(params.skato_rho, 0.999)
    if args.acat_beta:
        a1, a2 = (float(x) for x in args.acat_beta.split(","))
        params.acat_a1, params.acat_a2 = a1, a2
    if args.joint:
        params.joint_tests = [t.lower() for t in _split_list(args.joint)]
    if args.weights_col > 0:
        params.vc_with_weights = True
        params.vc_weight_col = args.weights_col
        params.vc_multiply_weights = args.multiply_weights
    if args.remeta_save_ld:
        if args.vc_MACthr != 0:
            raise SystemExit("ERROR: --remeta-save-ld option requires --vc-MACthr 0")
        params.remeta_save_ld = True
        params.remeta_ld_spr = args.remeta_ld_spr
    # GENE_P strategy setup (Regenie.cpp:787-803): forces burden ACAT
    # (+SBAT for QT), ACATV/SKATO-ACAT VC tests, 0.01 max AAF and the
    # RGC default AAF bins
    if args.rgc_gene_p and args.anno_file and args.mask_def:
        params.apply_gene_pval_strategy = True
        params.skip_sbat = args.skip_sbat
        params.genep_mask_sets_file = args.rgc_gene_def
        if args.vc_maxAAF == 1.0:
            params.vc_maxAAF = 0.01
        if "acat" not in params.joint_tests:
            params.joint_tests.append("acat")
        if not (args.bt or args.ct or args.t2e) and not args.skip_sbat and "sbat" not in params.joint_tests:
            params.joint_tests.append("sbat")
        if args.test == "additive":
            for t in ("acatv", "skato-acat"):
                if t not in params.vc_tests:
                    params.vc_tests.append(t)
        else:
            params.vc_tests = []
        if not args.aaf_bins:
            params.aaf_bins = ["0.00001", "0.0001", "0.001", "0.01"]
    params.mask_lovo = args.mask_lovo
    params.masks_loo_snpfile = args.lovo_snplist
    params.mask_lodo = args.mask_lodo
    if args.mask_lodo:
        # <set>,<mask>,<aaf_cutoff|singleton|all> (Regenie.cpp:982-1002)
        lodo_toks = args.mask_lodo.split(",")
        if len(lodo_toks) != 3:
            raise SystemExit("ERROR: wrong format for option --mask-lodo.")
        if args.mask_lovo:
            raise SystemExit(
                "ERROR: cannot use --mask-lovo with --mask-lodo.")
        if params.vc_tests:
            if lodo_toks[2] == "all":
                params.vc_maxAAF = 1.0
            elif lodo_toks[2] != "singleton":
                params.vc_maxAAF = float(lodo_toks[2])
        if params.write_masks:
            print("WARNING: cannot use --write-mask with --mask-lodo.")
            params.write_masks = False
    if (args.mask_lovo or args.mask_lodo):
        # Regenie.cpp:1028-1034
        if params.write_mask_snplist:
            print("WARNING: cannot use --write-mask-snplist with LOVO/LODO.")
            params.write_mask_snplist = False
        if params.write_setlist:
            print("WARNING: cannot use --write-setlist with LOVO/LODO.")
            params.write_setlist = None

    params.condition_list = args.condition_list
    params.condition_file = args.condition_file

    # LD matrix mode (Regenie.cpp:522-530)
    if args.sparse_thr is not None:
        # validated whenever the flag is passed (Regenie.cpp:919-924)
        if not args.skip_scaleG:
            raise SystemExit("ERROR: cannot use --sparse-thr without --skip-scaleG")
        if args.sparse_thr < 0 or args.sparse_thr >= 1:
            raise SystemExit(
                "ERROR: invalid value passed in --sparse-thr (must be in [0,1)")
    if args.compute_corr or args.output_corr_text:
        params.get_cor_mat = True
        params.ld_list_file = args.ld_extract
        params.cormat_force_vars = bool(
            (args.forcein_vars and args.extract) or args.ld_extract
        )
        params.cor_out_txt = args.output_corr_text or args.skip_scaleG
        params.skip_scaleG = args.skip_scaleG
        params.ld_sparse_thr = args.sparse_thr or 0.0
        params.skip_blups = True
        params.strict_mode = True
        params.trait_mode = QT
        params.min_mac = 0.5

    # interaction tests
    if args.interaction and args.interaction_snp:
        raise ValueError("cannot use both --interaction and --interaction-snp")
    if args.interaction:
        params.interaction_var = args.interaction
    elif args.interaction_snp:
        params.interaction_var = args.interaction_snp
        params.interaction_snp = True
        if args.interaction_file:
            params.interaction_file = args.interaction_file
            params.interaction_file_reffirst = args.interaction_file_reffirst
    if args.interaction_prs:
        if args.interaction or args.interaction_snp:
            raise SystemExit("ERROR: --interaction-prs excludes other interaction options")
        if not args.pred:
            raise SystemExit("ERROR: --interaction-prs requires --pred")
        params.interaction_var = "PRS"
        params.interaction_prs = True
        params.skip_blups = True  # PRS becomes the E variable, not an offset
    # conditional-GWAS mode for interaction tests (Regenie.cpp:626-634):
    # GxE conditions on E by default; GxG/GxPRS only with --force-condtl
    if args.interaction:
        params.gwas_condtl = not args.no_condtl
    elif args.interaction_snp or args.interaction_prs:
        params.gwas_condtl = args.force_condtl and not args.no_condtl
    params.hlm_vquad = not args.hlm_novquad
    params.print_vcov = args.print_vcov
    params.rare_mac_inter = args.rare_mac
    params.force_robust = args.force_robust or args.force_robust_hc4
    params.force_hc4 = args.force_robust_hc4
    params.no_robust = args.no_robust

    # time-to-event
    params.coxscore_exact = args.coxscore_exact
    params.cox_nofirth = args.coxnofirth
    if args.eventColList:
        params.event_cols = _split_list(args.eventColList)
        if params.trait_mode != T2E:
            raise ValueError("--eventColList must be used with --t2e")
        if len(params.event_cols) != len(params.pheno_cols):
            raise ValueError("--phenoColList and --eventColList must have same length")
        params.t2e_map = dict(zip(params.pheno_cols, params.event_cols))
        params.pheno_cols = params.pheno_cols + params.event_cols
    elif params.trait_mode == T2E:
        raise ValueError("must specify both --phenoColList and --eventColList for --t2e")
    if params.build_mask:
        params.min_mac_mask = params.min_mac
        params.min_mac = 0.5  # retain singletons (Masks.cpp:51)

    if params.step not in (1, 2):
        raise ValueError("--step must be 1 or 2")
    if not (params.bed_prefix or params.pgen_prefix or params.bgen_file):
        raise ValueError("must specify one of --bed/--pgen/--bgen")
    if params.step == 2 and not params.pred_list and not params.skip_blups:
        raise ValueError("step 2 requires --pred (or --ignore-pred)")
    return params


def unported(params: Params) -> Optional[str]:
    """Name of the first requested mode this port cannot run, or None.
    Every such mode raises NotImplementedError before any work. The CLI
    reaches only BED, BGEN and PGEN inputs (Params.file_type), which
    Step 2 takes all; the check stays for a caller that sets another."""
    if params.step == 2 and params.file_type not in ("bed", "bgen", "pgen"):
        return f"{params.file_type.upper()} input"
    return None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    params = args_to_params(args)
    # a multi-process run (parallel/dist.py): join the launch's process
    # group before any device work; every process runs this invocation
    # and only the output host writes the log and the files
    from .parallel import dist

    lines = []  # the distributed line, logged once the log is open
    dist.maybe_init_distributed(log=lines.append)
    try:
        return _run(argv, params, lines)
    finally:
        dist.shutdown()


def _run(argv, params: Params, lines) -> int:
    from .parallel.dist import _NullSink, is_output_host, process_count
    from .parallel.mesh import run_mesh
    from .utils.device import requested_device

    why = unported(params)
    if why is not None:
        raise NotImplementedError(f"{why}: not yet ported to regenie_tpu_torch")
    if process_count() > 1:
        # a launch whose processes hold different shard counts raises here,
        # in every process, before any work
        run_mesh(params, requested_device(None))

    out_host = is_output_host()
    with (open(params.out_prefix + ".log", "w") if out_host else _NullSink()) as log_fh:

        def log(msg=""):
            if not out_host:
                return
            print(msg)
            log_fh.write(str(msg) + "\n")
            log_fh.flush()

        log("Start time: " + time.strftime("%a %b %d %H:%M:%S %Y"))
        log("regenie_tpu_torch — PyTorch/CUDA whole-genome regression")
        log("Options in effect: " + " ".join(sys.argv[1:] if argv is None else argv))
        for line in lines:
            log(line)
        t0 = time.time()
        try:
            if params.step == 1:
                from .run_step1 import run_step1

                run_step1(params, log=log)
            else:
                from .run_step2 import run_step2

                run_step2(params, log=log)
        except Exception as e:
            log(f"ERROR: {e}")
            raise
        if params.debug:
            from .utils.stats import peak_rss_line

            log(peak_rss_line())
        log(f"Elapsed time : {time.time()-t0:.5g}s")
        log("End time: " + time.strftime("%a %b %d %H:%M:%S %Y"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
