"""Run configuration for regenie_tpu_torch (the port's own copy of
regenie_tpu/config.py).

Mirrors the reference's `struct param` (src/Regenie.hpp:181-437) — one flat
config object bound from CLI flags, validated once, then passed read-only
through the pipeline. The CLI takes every flag of regenie_tpu, so the
whole field set is kept; cli.unported() names the ones this port cannot run
yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

MISSING = -999.0  # internal missing code (reference uses -999)

# trait modes (reference: params->trait_mode)
QT = 0  # quantitative
BT = 1  # binary
CT = 2  # count/Poisson
T2E = 3  # time-to-event / Cox


@dataclass
class Params:
    # ---- run mode ----
    step: int = 0  # 1 or 2
    test_mode: bool = False  # step 2
    trait_mode: int = QT

    # ---- input files ----
    bed_prefix: Optional[str] = None
    pgen_prefix: Optional[str] = None
    bgen_file: Optional[str] = None
    sample_file: Optional[str] = None
    ref_first: bool = False
    bgi_file: Optional[str] = None
    pheno_file: Optional[str] = None
    cov_file: Optional[str] = None
    pred_list: Optional[str] = None  # step 2: _pred.list from step 1
    out_prefix: str = "regenie_tpu_out"

    # ---- phenotype / covariate selection ----
    pheno_cols: List[str] = field(default_factory=list)
    pheno_cols_rm: List[str] = field(default_factory=list)
    cov_cols: List[str] = field(default_factory=list)
    cov_cols_rm: List[str] = field(default_factory=list)
    cat_cov_cols: List[str] = field(default_factory=list)
    max_cat_levels: int = 10  # reference Regenie.hpp:207
    strict_mode: bool = False  # --strict
    rm_missing_qt: bool = True  # step 2: drop missing QT obs (ref default)
    cc12: bool = False  # 1/2/NA coding for BTs (default 0/1/NA => CC_ZeroOne)
    apply_rint: bool = False
    rerint: bool = False  # --apply-rerint (step-2 residual RINT)
    rerint_cov: bool = False  # --apply-rerint-cov
    min_case_count: int = 10  # --minCaseCount (Regenie.cpp:261)
    min_homs: float = 0.0  # --minHOMs (recessive test filter)

    # ---- sample filters ----
    keep_files: List[str] = field(default_factory=list)
    remove_files: List[str] = field(default_factory=list)
    extract_files: List[str] = field(default_factory=list)
    exclude_files: List[str] = field(default_factory=list)
    extract_or_files: List[str] = field(default_factory=list)  # --extract-or
    exclude_or_files: List[str] = field(default_factory=list)  # --exclude-or
    forced_mac_snpfile: Optional[str] = None  # --force-mac-filter
    forced_mac: float = -1.0

    # ---- step 1 model ----
    block_size: int = 1000  # --bsize
    cv_folds: int = 5  # --cv
    use_loocv: bool = False  # --loocv
    n_ridge_l0: int = 5  # --l0
    n_ridge_l1: int = 5  # --l1
    user_lambda: Optional[np.ndarray] = None
    user_tau: Optional[np.ndarray] = None
    niter_max_ridge: int = 100  # --niter (l1 logistic IRLS)
    use_adam: bool = False  # --use-adam ADAM pre-pass for l1 logistic ridge
    adam_mini: bool = False  # --adam-mini mini-batch ADAM (128-row batches)
    l1_ridge_eps: float = 1e-5  # ref Regenie.hpp
    force_step1: bool = False
    make_loco: bool = True
    print_prs: bool = False
    use_prs: bool = False
    write_l0_pred: bool = False  # --lowmem
    loco_tmp_prefix: Optional[str] = None
    split_l0: Optional[str] = None  # "PREFIX,N"
    run_l0: Optional[str] = None  # "MASTER,i"
    run_l1: Optional[str] = None  # "MASTER"
    select_pheno_l1: List[str] = field(default_factory=list)  # --l1-phenoList
    keep_l0: bool = False
    gz_out: bool = False

    # ---- step 2 test ----
    test_type: int = 0  # 0=additive, 1=dominant, 2=recessive
    min_mac: float = 5.0  # --minMAC
    min_info: float = 0.0  # --minINFO
    set_min_info: bool = False
    firth: bool = False
    firth_approx: bool = False  # --approx
    use_spa: bool = False
    skip_cf_burden: bool = False  # skip per-mask SKAT calibration factor
    alpha_pvalue: float = 0.05  # --pThresh
    skip_blups: bool = False  # --ignore-pred
    split_by_pheno: bool = True  # reference step-2 default writes per-pheno files
    htp_out: bool = False
    cohort_name: str = "NULL"
    af_cc: bool = False
    write_samples: bool = False
    print_pheno_name: bool = False  # --print-pheno (Regenie.cpp:295)
    chr_list: List[str] = field(default_factory=list)
    range_spec: Optional[str] = None
    range_chr: int = -1  # parsed --range CHR:MIN-MAX (Regenie.cpp:745)
    range_min: float = -1.0
    range_max: float = -1.0
    sex_specific: int = 0  # 0=all, 1=male-only, 2=female-only
    nb: Optional[int] = None
    starting_block: int = 1
    firth_se: bool = True  # back-correct SE using Firth LRT
    write_null_firth: bool = False
    use_null_firth: Optional[str] = None
    ltco_chr: int = -1  # --force-ltco (Regenie.cpp:288): LTCO scheme
    uncapped_pvals: bool = False  # --exact-p
    skip_test: bool = False  # --skip-test (Regenie.cpp:249)
    use_rel_path: bool = False  # --use-relative-path
    htp_use_eventname: bool = False  # --htp-with-event
    early_exit: bool = False  # --early-exit (Regenie.cpp:309)
    condition_file_sample: Optional[str] = None
    interaction_file_sample: Optional[str] = None

    # ---- chrX non-PAR handling (--par-region/--skip-dosage-comp,
    # Regenie.cpp:253,275; in_non_par Geno.cpp:2802) ----
    build_code: str = "hg38"
    par1_max_bound: int = 2781479
    par2_min_bound: int = 155701383
    skip_dosage_comp: bool = False

    # ---- multi-trait tests (--mt, Regenie.cpp:342) ----
    trait_set: bool = False

    print_cov_betas: bool = False  # --print-cov-betas (Regenie.cpp:310)
    test_l0: bool = False  # --test-l0 SNP pre-screen (Regenie.cpp:313)
    l0_snp_pval_thr: float = -1.0  # --l0-pval-thr

    # ---- transposed phenotype input (--tpheno-file, Regenie.cpp:262) ----
    transposed_pheno: bool = False
    tpheno_index_col: int = 1
    tpheno_ignore_cols: List[int] = field(default_factory=list)
    tpheno_iid_only: bool = False

    # ---- MultiPhen reverse-ordinal test (--multiphen, Regenie.hpp:410) ----
    multiphen: bool = False
    multiphen_thr: float = 0.001
    multiphen_tol: float = 2.5e-4
    multiphen_firth_mult: float = 1.0
    multiphen_maxstep: float = 200.0
    multiphen_maxit: int = 150
    multiphen_approx_offset: int = -1  # MAC gate for the offset-frozen LRT
    multiphen_test: str = "nocov_score_offset"  # --multiphen-test strategy

    ld_list_file: Optional[str] = None  # --ld-extract (Regenie.cpp:299)
    bgi_file: Optional[str] = None  # --bgi (Regenie.cpp:158)

    # ---- MCC test for skewed QTs (--mcc, Regenie.cpp:343-345) ----
    mcc_test: bool = False
    mcc_skew: float = 0.0  # abs skewness threshold to flag a trait
    mcc_thr: float = 0.01  # raw p threshold; ==1 => MCC everywhere
    mcc_apply_thr: bool = False  # derived: mcc_thr < 1
    mcc_thr_nlog10: float = 2.0

    # ---- gene-based tests (Masks.cpp / SKAT.cpp / Joint_Tests.cpp) ----
    set_list: Optional[str] = None  # --set-list
    anno_file: Optional[str] = None  # --anno-file
    anno_labels_file: Optional[str] = None  # --anno-labels
    mask_def: Optional[str] = None  # --mask-def
    aaf_bins: List[str] = field(default_factory=list)  # --aaf-bins
    mask_rule: str = "max"  # max | sum | comphet (Regenie.hpp:381)
    build_mask: bool = False
    min_mac_mask: float = 5.0  # mask-level MAC filter (set from min_mac)
    write_masks: bool = False
    write_mask_snplist: bool = False
    write_setlist: Optional[str] = None
    check_burden_files: bool = False
    singleton_carriers: bool = False  # --singleton-carrier
    set_aaf_file: Optional[str] = None  # --aaf-file
    extract_sets: Optional[str] = None
    exclude_sets: Optional[str] = None
    extract_setlist: List[str] = field(default_factory=list)
    exclude_setlist: List[str] = field(default_factory=list)
    vc_tests: List[str] = field(default_factory=list)  # --vc-tests skat,skato,...
    vc_maxAAF: float = 1.0  # --vc-maxAAF (default: "all" bin)
    skat_collapse_MAC: float = 10.0  # ultra-rare collapse threshold
    skat_a1: float = 1.0  # Beta(a1,a2) weights (Regenie.hpp:394)
    skat_a2: float = 25.0
    acat_a1: float = 1.0  # ACAT weight Beta params (--acat-beta)
    acat_a2: float = 25.0
    p_joint_only: bool = False  # --joint-only (Regenie.cpp:486)
    sbat_napprox: int = 10  # --sbat-napprox sampled sets per chi-bar weight
    sbat_adapt: bool = False  # --sbat-adapt (nnls_adaptive, Regenie.cpp:513)
    sbat_mtw: bool = False  # --sbat-mtw reuse weights across traits (Regenie.cpp:514)
    sbat_verbose: bool = False  # --sbat-verbose pos/neg split rows (Regenie.cpp:512)
    t_test: bool = False  # --t-test (QT p via t-distribution)
    compute_all_chr: bool = False  # --compute-all (Regenie.cpp:208)
    alpha_prior: float = -1.0  # --prior-alpha MAF-dependent prior (Data.cpp:215)
    skip_cov_res: bool = False  # --nocov-approx (Data.cpp:2513)
    cormat_force_vars: bool = False  # --forcein-vars (Regenie.cpp:524)
    blup_cov: bool = False  # --prs-cov: step-1 preds as covariate (Pheno.cpp:1786)
    l1_full_samples: bool = False  # --l1-full (Data.cpp:1085)
    print_block_betas: bool = False  # --print (Data.cpp:511)
    t2e_event_l0: bool = False  # --t2e-event-l0 (Step1_Models.cpp:2259)
    t2e_l1_pi6: bool = False  # --t2e-l1-pi6 (Step1_Models.cpp:2106)
    select_l0: bool = False  # --select-l0 (Step1_Models.cpp:1989)
    l0_pvals_file: Optional[str] = None  # --select-l0 FILE
    rm_l0_pct: float = 0.0  # --rm-l0-pct (Step1_Models.cpp:2014)
    mse_full: bool = False  # --mse-full QT variance adjustment (Step2_Models.cpp:434)
    skato_rho: Optional[np.ndarray] = None  # default grid set in SKAT module
    joint_tests: List[str] = field(default_factory=list)  # --joint minp,acat,...
    aaf_file_wSingletons: bool = False  # --set-singletons (Regenie.cpp:238)

    # custom VC weights (--weights-col/--multiply-weights, Regenie.cpp:243,509)
    vc_with_weights: bool = False
    vc_multiply_weights: bool = False
    vc_weight_col: int = 0  # 1-based column in the annotation file

    # remeta LD output (--remeta-save-ld, Regenie.cpp:346-347)
    remeta_save_ld: bool = False
    remeta_ld_spr: float = 0.01

    # GENE_P strategy (--rgc-gene-p/--rgc-gene-def, Regenie.cpp:330-332,787)
    apply_gene_pval_strategy: bool = False
    genep_mask_sets_file: Optional[str] = None
    skip_sbat: bool = False
    mask_lovo: Optional[str] = None
    masks_loo_snpfile: Optional[str] = None  # --lovo-snplist  # --mask-lovo SET,MASK,BIN
    mask_lodo: Optional[str] = None  # --mask-lodo SET,MASK,AAF_CUTOFF
    use_max_bsize: bool = False

    # ---- time-to-event (Cox) ----
    event_cols: List[str] = field(default_factory=list)  # --eventColList
    t2e_map: Dict[str, str] = field(default_factory=dict)  # time -> event
    coxscore_exact: bool = False
    cox_nofirth: bool = False
    t2e_event_l0: bool = False
    t2e_l1_pi6: bool = False

    # ---- LD matrix mode (ld_comp, Data.cpp:3807) ----
    get_cor_mat: bool = False  # --compute-corr
    cor_out_txt: bool = False  # --output-corr-text
    skip_scaleG: bool = False
    ld_sparse_thr: float = 0.0

    # ---- conditional analysis (extract_condition_snps, Pheno.cpp:940) ----
    condition_list: Optional[str] = None  # file of variant IDs
    condition_file: Optional[str] = None  # FORMAT,FILE external genotypes
    max_condition_vars: int = 10000

    # ---- interaction tests (Interaction.cpp / HLM.cpp) ----
    interaction_var: Optional[str] = None  # --interaction / --interaction-snp
    interaction_snp: bool = False
    interaction_file: Optional[str] = None  # --interaction-file FORMAT,FILE
    interaction_file_reffirst: bool = False
    rare_mac_inter: float = 1000.0  # --rare-mac (Regenie.hpp:322)
    print_vcov: bool = False  # --print-vcov (Interaction.cpp:604)
    interaction_prs: bool = False  # --interaction-prs (Regenie.cpp:225)
    gwas_condtl: bool = False  # condition on E in marginal GWAS (Regenie.hpp:325)
    force_robust: bool = False
    force_hc4: bool = False
    no_robust: bool = False
    ncov_interaction: int = 1
    interaction_istart: int = 0
    int_add_extra_term: bool = False  # E has an E^2 companion (Pheno.cpp:1030)
    int_add_esq: bool = False  # BT: E^2 main-effect column (Pheno.cpp:1137)
    hlm_vquad: bool = True  # HLM variance model gets E^2 (--hlm-novquad)

    # ---- numerics (reference Regenie.hpp defaults) ----
    numtol: float = 1e-6
    numtol_eps: float = 10.0 * np.finfo(np.float64).eps
    qr_tol: float = 1e-7
    eigen_val_rel_tol: float = 1e-16
    niter_max: int = 30  # null GLM IRLS iterations
    niter_max_firth: int = 250
    niter_max_firth_null: int = 1000
    niter_max_line_search: int = 5
    maxstep: int = 5  # max step size in firth per-SNP
    maxstep_null: int = 25
    retry_maxstep_firth: int = 5
    retry_niter_firth: int = 5000
    tol_spa: float = 5e-5  # SPA root finding tolerance (ref: missing_value_double tol)
    niter_max_spa: int = 1000
    zcrit: float = 1.959963984540054  # qnorm(0.975)
    prop_zero_thr: float = 0.995  # sparse G threshold (Regenie.hpp:311)
    z_thr: float = 0.0
    chunk_mb: float = 1000.0

    # ---- misc ----
    n_chrom: int = 23  # autosomes + X => nChrom in reference
    threads: int = 0
    verbose: bool = False
    debug: bool = False
    seed: int = 1

    # ---- derived at runtime ----
    n_samples: int = 0
    n_analyzed: int = 0
    n_pheno: int = 0
    ncov: int = 0
    ncov_analyzed: int = 0
    n_variants: int = 0
    total_n_block: int = 0

    @property
    def file_type(self) -> str:
        if self.bgen_file:
            return "bgen"
        if self.pgen_prefix:
            return "pgen"
        return "bed"

    pgen_dosage_present: bool = False  # set at open (PgrGetRawSampleCt path)

    @property
    def dosage_mode(self) -> bool:
        """INFO column presence (Geno.cpp:175,1101): bgen in test mode, or
        pgen files that contain dosage tracks."""
        if self.file_type == "bgen":
            return self.test_mode
        if self.file_type == "pgen":
            return self.pgen_dosage_present
        return False


def ridge_h2_grid(n: int) -> np.ndarray:
    """Heritability grid for ridge params.

    Reference `set_ridge_params` (src/Regenie.cpp:1497-1508): n evenly
    spaced points in [0,1] with endpoints replaced by 0.01 and 0.99.
    """
    if n < 2:
        raise ValueError("number of ridge parameters must be at least 2")
    step = 1.0 / (n - 1)
    vec = np.arange(n, dtype=np.float64) * step
    vec[0] = 0.01
    vec[-1] = 0.99
    return vec
