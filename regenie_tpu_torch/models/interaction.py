"""GxE, GxG and GxPRS interaction tests (the port of
regenie_tpu/models/interaction.py): quantitative traits by the HC3/HC4
robust sandwich, or for rare variants the heteroskedastic linear model
(HLM); binary traits by a logistic refit of [E, G, GxE] on the null
offset with a model-based or HC3 covariance and a Firth LRT fallback.
Reference Interaction.cpp (get_interaction_terms :44,
apply_interaction_tests_qt :109, _HLM :289, _bt :441, _firth :664) and
HLM.cpp (Var(y) = sigma^2 exp(V b)).

The batched paths run as float64 torch ops on the engine's device: the
robust sandwich of a chunk of SNPs (_robust_batch), the whitened HLM
projections (_hlm_block_batched) and the logistic refits, two masked
IRLS passes (bt_irls_batched). On the card every chunk has one fixed
shape for the run (the last padded), sized to the free memory, so that a
SNP's numbers do not depend on its neighbours; the rows render in Python
(sumstat_line_single, the bytes of the native formatter). On the CPU the
routing is the JAX package's: the batched paths where it takes them (its
native row formatter present; BT with REGENIE_TPU_BATCH_INT=1), the
per-SNP numpy loops otherwise and under REGENIE_TPU_NO_BATCH_INT=1.

The HLM null is fitted per trait by scipy's L-BFGS-B on the host; on the
card each evaluation of its objective and gradient runs there in
float64 (hlm_fit_null), on the CPU the JAX package's numpy arithmetic.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from scipy.optimize import minimize

from ..config import BT, QT, Params
from ..io.output import native_formatter, sumstat_line_single
from ..utils.stats import chisq_neglog10, chisq_neglog10_df

NO_BATCH_ENV = "REGENIE_TPU_NO_BATCH_INT"  # every SNP through the numpy loops
BATCH_ENV = "REGENIE_TPU_BATCH_INT"  # BT: the batched IRLS on the CPU too


@dataclass
class HLMNull:
    """Null heteroskedastic LM per trait (HLM.cpp). On the card Dinv_sqrt,
    Px and yres are device tensors ([N, P], [N, q] a trait, [N, P]); on
    the CPU numpy arrays. fits: per trait (objective, converged, L-BFGS
    iterations, objective evaluations)."""

    V: np.ndarray = None  # [N, 1+K] variance covariates (1, E...)
    Vlin: np.ndarray = None  # [N, 1+K] (1, E) un-normalized
    X: np.ndarray = None  # [N, C(+1)] mean covariates (+ blup)
    Dinv_sqrt: object = None  # [N, P]
    Px: List[object] = field(default_factory=list)
    yres: object = None  # [N, P]
    fits: List[Optional[tuple]] = field(default_factory=list)


@dataclass
class InteractionState:
    evar_name: str = ""
    E: np.ndarray = None  # [N, K] interaction variable(s)
    E_res: np.ndarray = None  # [N, K] residualized+scaled
    scl_E: np.ndarray = None  # [K]
    lvl_names: List[str] = field(default_factory=list)
    is_cat: bool = False
    hlm: Optional[HLMNull] = None
    interaction_snp_name: Optional[str] = None


def add_square_term(E: np.ndarray) -> bool:
    """Whether an E^2 term accompanies E (add_square_term,
    Pheno.cpp:1030): single-column E that is not dichotomous, or
    dichotomous without a 0 level."""
    if E.shape[1] > 1:  # categorical
        return False
    vals = np.unique(E[:, 0])
    if len(vals) > 2:
        return True
    return not np.any(vals == 0)


def residualize_matrix(mat, X, n, numtol=1e-6):
    """Project X out of mat columns and scale (residualize_matrix,
    Pheno.cpp:1843). Returns (mat_res, scf) or (None, None) if sd=0."""
    beta = mat.T @ X
    m = mat - X @ beta.T
    scf = np.linalg.norm(m, axis=0) / np.sqrt(n - X.shape[1])
    if scf.min() < numtol:
        return None, None
    return m / scf[None, :], scf


def extract_interaction_E(params: Params, pd, gd, log) -> np.ndarray:
    """Build E for GxG/GxPRS and stash it on pd (extract_interaction_snp /
    extract_interaction_prs, Pheno.cpp:86-90, 927, 1393). Returns a keep
    mask: individuals with a missing interaction genotype are dropped from
    the analysis (read_snp mean_impute=false, Geno.cpp:3990-3994)."""
    N = params.n_samples
    keep = np.ones(N, dtype=bool)

    if params.interaction_prs:
        # GxPRS: full PRS recovered from the LOCO file
        # (extract_interaction_prs + read_prs, Pheno.cpp:1393-1460)
        from ..io.files import open_read, string_split
        from ..run_step2 import read_pred_list

        if params.n_pheno > 1:
            raise ValueError("option '--interaction-prs' only works with a single phenotype")
        blup_files = read_pred_list(params.pred_list)
        name = pd.pheno_names[0]
        prs = np.zeros(N)
        nchr = 0
        with open_read(blup_files[name]) as fh:
            header = string_split(fh.readline())
            id_to_ind = {s.key: i for i, s in enumerate(gd.samples)}
            for line in fh:
                toks = string_split(line)
                if not toks:
                    continue
                for col in range(1, len(header)):
                    k = id_to_ind.get(header[col])
                    if k is not None and toks[col] != "NA":
                        prs[k] += float(toks[col])
                nchr += 1
        if nchr > 1:
            prs /= nchr - 1  # sum of loco rows = (nchr-1) * PRS
        pd.interaction_cov = prs[:, None]
        pd.interaction_lvl_names = ["PRS"]
    else:
        # GxG: the SNP from the main file or an external one
        # (--interaction-file FORMAT,FILE; extract_from_genofile,
        # Geno.hpp:265)
        if params.interaction_file:
            from ..io.geno import open_geno

            fmt_name, path = params.interaction_file.split(",", 1)
            sub = Params(
                step=params.step, pheno_file=params.pheno_file,
                bed_prefix=path if fmt_name == "bed" else None,
                bgen_file=path if fmt_name == "bgen" else None,
                pgen_prefix=path if fmt_name == "pgen" else None,
                n_chrom=params.n_chrom,
                ref_first=params.interaction_file_reffirst,
                sample_file=params.interaction_file_sample,
            )
            gd2 = open_geno(sub)
            try:
                snps2 = [s for s in gd2.snps if s.ID == params.interaction_var]
                if not snps2:
                    raise ValueError(
                        f"interaction SNP '{params.interaction_var}' not found in "
                        f"--interaction-file"
                    )
                G_ext = gd2.read_block_scattered(snps2).astype(np.float64)[0]
                idx_ext = gd2.sample_index()
            finally:
                gd2.close()
            G = np.full(gd.n_samples, -3.0)
            for j, smp in enumerate(gd.samples):
                k = idx_ext.get(smp.key)
                if k is not None:
                    G[j] = G_ext[k]
        else:
            idx = [i for i, s in enumerate(gd.snps) if s.ID == params.interaction_var]
            if not idx:
                raise ValueError(f"interaction SNP '{params.interaction_var}' not found")
            G = gd.read_block_scattered([gd.snps[idx[0]]]).astype(np.float64)[0]
        miss = G == -3
        keep = ~miss
        G = np.where(miss, 0.0, G)  # dropped below; no mean imputation
        pd.interaction_cov = G[:, None]
        pd.interaction_snp_name = params.interaction_var
        pd.interaction_lvl_names = [params.interaction_var]
        # GxG automatically uses LTCO with the interaction SNP's
        # chromosome (Regenie.cpp:622 w_ltco; Geno.cpp:4251)
        if params.ltco_chr <= 0 and not params.skip_blups:
            snp_chr = next(
                (s.chrom for s in gd.snps if s.ID == params.interaction_var),
                -1,
            )
            if snp_chr > 0:
                params.ltco_chr = snp_chr
                log(f"   -using LTCO scheme for chr {snp_chr} (interaction SNP)")
    pd.interaction_is_cat = False
    return keep


def prep_interaction(params: Params, pd, gd, log) -> InteractionState:
    """Load the interaction variable and residualize it (prep_run
    interaction section, Pheno.cpp:1126-1165). E itself was built earlier
    in prepare() (covariate read for GxE; extract_interaction_E for
    GxG/GxPRS) so that --force-condtl can add it to the covariates."""
    st = InteractionState()
    st.evar_name = params.interaction_var
    st.E = pd.interaction_cov
    st.is_cat = getattr(pd, "interaction_is_cat", False)
    st.lvl_names = getattr(pd, "interaction_lvl_names", [params.interaction_var])
    st.interaction_snp_name = getattr(pd, "interaction_snp_name", None)

    params.ncov_interaction = st.E.shape[1]
    params.int_add_extra_term = not st.is_cat and add_square_term(st.E)
    if params.gwas_condtl:
        # E already conditioned on as a covariate: no E main-effect
        # columns in the interaction model (get_interaction_terms,
        # Interaction.cpp:87-91)
        st.E_res = np.zeros((params.n_samples, 0))
        st.scl_E = np.ones(0)
        params.interaction_istart = 0
    else:
        # BT with a non-dichotomous E carries an E^2 main-effect column
        # (int_add_esq, Pheno.cpp:1137-1142)
        params.int_add_esq = params.trait_mode == BT and params.int_add_extra_term
        main = np.column_stack([st.E, st.E**2]) if params.int_add_esq else st.E
        # residualize E (and E^2) on the covariate basis
        E_res, scf = residualize_matrix(main, pd.new_cov, params.n_analyzed, params.numtol)
        if E_res is None:
            raise ValueError("Var=0 for the interaction risk factor")
        st.E_res = E_res
        st.scl_E = scf
        params.interaction_istart = main.shape[1]  # main-effect columns in M

    if params.trait_mode == QT and not params.no_robust and not params.force_robust:
        st.hlm = _hlm_prep(params, pd, st)
    return st


# ---------------------------------------------------------------------------
# HLM null model
# ---------------------------------------------------------------------------

def _qr_prune(mat: np.ndarray, qr_tol: float = 1e-7) -> np.ndarray:
    """Keep a linearly independent subset of columns in pivot order
    (apply_QR, Pheno.cpp:1861 via ColPivHouseholderQR)."""
    from scipy.linalg import qr as _qr

    _, R, piv = _qr(mat, mode="economic", pivoting=True)
    diag = np.abs(np.diag(R))
    rank = int((diag > diag[0] * qr_tol).sum()) if diag.size else 0
    if rank == 0:
        raise ValueError("rank of matrix is 0")
    return mat[:, sorted(piv[:rank])] if rank < mat.shape[1] else mat


def _center_scale(V: np.ndarray, N: int) -> np.ndarray:
    out = V.copy()
    for k in range(out.shape[1]):
        mu = out[:, k].sum() / N
        out[:, k] = out[:, k] - mu
        sc = np.linalg.norm(out[:, k]) / np.sqrt(N - 1)
        out[:, k] /= sc
    return out


def _hlm_prep(params, pd, st) -> HLMNull:
    """HLM null-model design (HLM::prep_run, HLM.cpp:49-93): the variance
    model gets an E^2 column for non-dichotomous E (unless --hlm-novquad)
    and the mean model gets E^2 as an extra covariate."""
    h = HLMNull()
    N = params.n_samples
    h.Vlin = np.column_stack([np.ones(N), st.E])
    if params.hlm_vquad and params.int_add_extra_term:
        # V = (1, QR(E, E^2) centered+scaled) (HLM.cpp:55-64)
        U = _qr_prune(np.column_stack([st.E, st.E**2]))
        h.V = np.column_stack([np.ones(N), _center_scale(U, N)])
    else:
        # V = (1, centered+scaled E)
        h.V = np.column_stack(
            [np.ones(N), _center_scale(np.asarray(st.E, dtype=np.float64), N)]
        )
    if params.int_add_extra_term:
        # X = QR(covs, E^2) (HLM.cpp:76-81)
        h.X = _qr_prune(np.column_stack([pd.new_cov, st.E**2]))
    else:
        h.X = pd.new_cov.copy()
    return h


def _hlm_objective_np(V, X, y, maskf, n):
    """The null HLM's alpha solve and objective on the host (numpy, the
    JAX package's arithmetic): (get_alpha, obj)."""

    def get_alpha(beta):
        Vb = V @ beta
        Dinv = np.exp(-Vb) * maskf
        Xd = (X * Dinv[:, None]).T
        alpha = np.linalg.lstsq(Xd @ X, Xd @ y, rcond=None)[0]
        return Vb, Dinv, alpha

    def obj(beta):
        Vb, Dinv, alpha = get_alpha(beta)
        esq = (y - X @ alpha) ** 2
        fval = ((Vb + Dinv * esq) * maskf).sum() / n
        grad = V.T @ (((1 - esq * Dinv) * maskf) / n)
        return fval, grad

    def start():
        beta0 = np.zeros(V.shape[1])
        _, _, alpha = get_alpha(beta0)
        esq = ((y - X @ alpha) * maskf) ** 2
        try:
            return np.linalg.lstsq(V.T @ (V * esq[:, None]), V.T @ ((esq - 1) * maskf),
                                   rcond=None)[0]
        except np.linalg.LinAlgError:
            return beta0

    return get_alpha, obj, start


def _hlm_objective_dev(V, X, y, maskf, n):
    """The same on the device (float64 tensors): the [N, C] weighted Gram
    and the objective's sums there, the C x C solve on the host (numpy's
    lstsq, as the CPU twin), one copy to the host an evaluation."""

    def get_alpha(beta):
        Vb = V @ torch.as_tensor(beta, device=V.device)
        Dinv = torch.exp(-Vb) * maskf
        Xd = X * Dinv[:, None]
        ab = torch.cat([Xd.T @ X, (Xd.T @ y)[:, None]], dim=1).cpu().numpy()
        alpha = np.linalg.lstsq(ab[:, :-1], ab[:, -1], rcond=None)[0]
        return Vb, Dinv, torch.as_tensor(alpha, device=V.device)

    def obj(beta):
        Vb, Dinv, alpha = get_alpha(beta)
        esq = (y - X @ alpha) ** 2
        fval = ((Vb + Dinv * esq) * maskf).sum() / n
        grad = V.T @ (((1 - esq * Dinv) * maskf) / n)
        fg = torch.cat([fval[None], grad]).cpu().numpy()
        return float(fg[0]), fg[1:]

    def start():
        beta0 = np.zeros(V.shape[1])
        _, _, alpha = get_alpha(beta0)
        esq = ((y - X @ alpha) * maskf) ** 2
        ab = torch.cat([V.T @ (V * esq[:, None]), (V.T @ ((esq - 1) * maskf))[:, None]],
                       dim=1).cpu().numpy()
        try:
            return np.linalg.lstsq(ab[:, :-1], ab[:, -1], rcond=None)[0]
        except np.linalg.LinAlgError:
            return beta0

    return get_alpha, obj, start


def hlm_fit_null(params, pd, st, blups, log, device=None):
    """Fit the null HLM per trait (HLM_fitNull, HLM.cpp:100): L-BFGS-B on
    the host, a trait at a time; on a CUDA device the objective, the
    gradient and the whitened projections run there in float64 (Px, yres,
    Dinv_sqrt stay on the card), else in numpy as in the JAX package."""
    h = st.hlm
    N, P = pd.phenotypes.shape
    dev = torch.device(device) if device is not None else torch.device("cpu")
    on_card = dev.type == "cuda"
    X = h.X if params.skip_blups else np.column_stack([h.X, np.zeros(N)])
    h.Px = [None] * P
    h.fits = [None] * P
    if on_card:
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=dev)  # noqa: E731
        V_t, X_t = put(h.V), put(X)
        h.Dinv_sqrt = torch.zeros((N, P), dtype=torch.float64, device=dev)
        h.yres = torch.zeros((N, P), dtype=torch.float64, device=dev)
    else:
        h.Dinv_sqrt = np.zeros((N, P))
        h.yres = np.zeros((N, P))

    for ph in range(P):
        if not pd.pheno_pass[ph]:
            continue
        maskf = pd.masked_indivs[:, ph].astype(np.float64)
        y = pd.phenotypes[:, ph]  # QT: residualized+scaled
        if not params.skip_blups:
            X[:, -1] = blups[:, ph]
        n = pd.Neff[ph]
        if on_card:
            if not params.skip_blups:
                X_t[:, -1] = put(blups[:, ph])
            y_t, mf_t = put(y), put(maskf)
            get_alpha, obj, start = _hlm_objective_dev(V_t, X_t, y_t, mf_t, n)
        else:
            get_alpha, obj, start = _hlm_objective_np(h.V, X, y, maskf, n)
        res = minimize(obj, start(), jac=True, method="L-BFGS-B",
                       options={"maxiter": 100})
        h.fits[ph] = (float(res.fun), bool(res.success), int(res.nit), int(res.nfev))
        _, Dinv, _ = get_alpha(res.x)
        if on_card:
            Ds = torch.sqrt(Dinv)
            Xd = X_t * Ds[:, None]
            D, Vv = torch.linalg.eigh(Xd.T @ Xd)
            nz = D > D[-1] * 1e-12
            Px = (Xd @ Vv[:, nz]) / torch.sqrt(D[nz])[None, :]
            ym = y_t * Ds
            h.Dinv_sqrt[:, ph] = Ds
            h.yres[:, ph] = ym - Px @ (Px.T @ ym)
        else:
            h.Dinv_sqrt[:, ph] = np.sqrt(Dinv)
            Xd = X * h.Dinv_sqrt[:, ph][:, None]
            D, Vv = np.linalg.eigh(Xd.T @ Xd)
            nz = D > D[-1] * 1e-12
            Px = (Xd @ Vv[:, nz]) / np.sqrt(D[nz])[None, :]
            ym = y * h.Dinv_sqrt[:, ph]
            h.yres[:, ph] = ym - Px @ (Px.T @ ym)
        h.Px[ph] = Px


def _np(x):
    """A host float64 array of a tensor or array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)


# ---------------------------------------------------------------------------
# per-block interaction tests
# ---------------------------------------------------------------------------

def _on_card(eng) -> bool:
    return eng.device.type == "cuda"


def _batched_rows(eng) -> bool:
    """Whether the batched HLM / BT paths and the mixed-block row buffer
    run: always on the card (rows render in Python); on the CPU where the
    JAX package takes them, with its native row formatter."""
    return _on_card(eng) or native_formatter("format_sumstat_single") is not None


def chunk_size(eng, key: str, row_bytes: float, cpu_budget: float = 2.0e8) -> int:
    """SNPs a chunk of a batched path: on the card a tenth of the free
    device memory over the bytes a SNP takes, within [1, 256], fixed for
    the run; on the CPU the JAX package's budget (`cpu_budget` bytes)."""
    sizes = eng.__dict__.setdefault("_int_chunks", {})
    if key not in sizes:
        if _on_card(eng):
            free, _ = torch.cuda.mem_get_info(eng.device)
            sizes[key] = int(min(256, max(1, free / 10 / row_bytes)))
        else:
            sizes[key] = max(1, int(cpu_budget / max(1.0, row_bytes)))
    return sizes[key]


def _chunks(eng, idx, S):
    """Chunks of idx of S SNPs each: [(indices, real count)]. On the card
    the last is padded with its last SNP to the run's one shape; on the
    CPU none is."""
    out = []
    for c0 in range(0, len(idx), S):
        chunk = list(idx[c0 : c0 + S])
        real = len(chunk)
        if _on_card(eng):
            chunk = chunk + [chunk[-1]] * (S - real)
        out.append((chunk, real))
    return out


class _Block:
    """A block's genotypes for the interaction tests: the imputed G and
    (QT) the residualized G_res, as given (device tensors or host arrays),
    with host copies made on first use by the numpy paths."""

    def __init__(self, G_raw, G_res, dev):
        self.G_raw, self.G_res, self.dev = G_raw, G_res, dev
        self._host = {}

    def dev_rows(self, which, rows):
        g = self.G_raw if which == "raw" else self.G_res
        if isinstance(g, torch.Tensor):
            return g[torch.as_tensor(rows, device=g.device)].to(self.dev, torch.float64)
        return torch.as_tensor(np.asarray(g, np.float64)[rows], device=self.dev)

    def host(self, which, b):
        if which not in self._host:
            self._host[which] = _np(self.G_raw if which == "raw" else self.G_res)
        return self._host[which][b]


def apply_interaction_block(params, eng, bsnps, G_raw, G_res, result, writers, test_name):
    """Interaction tests for every SNP of a tested block (the JAX
    package's apply_interaction_block, single process). G_raw: [B, N]
    imputed (for BT flipped) genotypes; G_res: [B, N] residualized and
    scaled (QT); either a tensor on the engine's device or a host array.
    A QT SNP goes to the HLM when any trait's MAC is below --rare-mac, else
    to the robust sandwich; the rows of a block mixing both render in one
    call, in SNP order."""
    st = eng.interaction
    B = len(bsnps)
    P = params.n_pheno
    blk = _Block(G_raw, G_res, eng.device)
    robust_idx, bt_idx, hlm_idx = [], [], []
    no_batch = bool(os.environ.get(NO_BATCH_ENV))
    bt_use_batched = (params.trait_mode == BT and not no_batch
                      and (bool(os.environ.get(BATCH_ENV)) or _on_card(eng)))
    counts = eng.__dict__.setdefault(
        "int_counts", {"robust": 0, "hlm": 0, "bt": 0, "robust_s": 0.0,
                       "hlm_s": 0.0, "bt_s": 0.0, "rows_s": 0.0})
    timer = _Timer(eng)
    for b in range(B):
        if result.ignored[b]:
            continue
        if st.interaction_snp_name and bsnps[b].ID == st.interaction_snp_name:
            continue
        if params.trait_mode == BT:
            counts["bt"] += 1
            if bt_use_batched:
                bt_idx.append(b)
            else:
                _test_snp_bt(params, eng, bsnps[b], b, blk.host("raw", b), result,
                             writers, test_name)
            continue
        mac_b = result.af_t[b] * 2 * result.ns_t[b]
        mac_b = np.minimum(mac_b, 2 * result.ns_t[b] - mac_b)
        use_hlm = st.hlm is not None and (mac_b < params.rare_mac_inter).any()
        counts["hlm" if use_hlm else "robust"] += 1
        if use_hlm:
            if no_batch:
                _test_snp_hlm(params, eng, bsnps[b], b, blk.host("raw", b), result,
                              writers, test_name)
            else:
                hlm_idx.append(b)
        elif no_batch:
            _test_snp_robust(params, eng, bsnps[b], b, blk.host("raw", b),
                             blk.host("res", b), result, writers, test_name)
        else:
            robust_idx.append(b)
    # the per-SNP routes' seconds count to their route
    counts["bt_s" if params.trait_mode == BT else "robust_s"] += timer.lap()
    # shared block-level stat buffers: HLM and robust SNPs of a mixed
    # block render in ONE call so the file keeps the per-SNP row order
    out = None
    if hlm_idx and robust_idx and not params.print_vcov and _batched_rows(eng):
        tmpl = _int_row_templates(params, st, params.interaction_istart,
                                  params.ncov_interaction, test_name,
                                  not _on_card(eng))
        if tmpl is not None:
            T = len(tmpl[1])
            out = {"tests": tmpl[1],
                   "beta": np.full((B, P, T), -1.0), "se": np.full((B, P, T), -1.0),
                   "chisq": np.full((B, P, T), -1.0), "logp": np.full((B, P, T), -1.0),
                   "emit": np.zeros((B, P), bool)}
    if hlm_idx:
        if not _hlm_block_batched(params, eng, bsnps, hlm_idx, blk, result, writers,
                                  test_name, out):
            for b in hlm_idx:
                _test_snp_hlm(params, eng, bsnps[b], b, blk.host("raw", b), result,
                              writers, test_name)
        counts["hlm_s"] += timer.lap()
    if bt_idx:
        if not _bt_block_batched(params, eng, bsnps, bt_idx, blk, result, writers,
                                 test_name):
            for b in bt_idx:
                _test_snp_bt(params, eng, bsnps[b], b, blk.host("raw", b), result,
                             writers, test_name)
        counts["bt_s"] += timer.lap()
    if robust_idx:
        _robust_block_batched(params, eng, bsnps, robust_idx, blk, result, writers,
                              test_name, out)
        counts["robust_s"] += timer.lap()
    if out is not None and out["emit"].any():
        _render_int_rows(params, eng, writers, bsnps, list(range(B)), out["emit"],
                         out["tests"], out["beta"], out["se"], out["chisq"],
                         out["logp"], result)
    counts["rows_s"] += timer.lap()


class _Timer:
    """Seconds between laps, the device's queue drained at each."""

    def __init__(self, eng):
        self.dev = eng.device
        self.t = self._now()

    def _now(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.time()

    def lap(self):
        t, self.t = self.t, self._now()
        return self.t - t


# ---------------------------------------------------------------------------
# robust sandwich (QT)
# ---------------------------------------------------------------------------

class RobustConsts:
    """The robust path's per-chromosome device operands: E, E_res, the
    covariate basis, the residuals and the masks (float64)."""

    def __init__(self, eng):
        st, pd, dev = eng.interaction, eng.pd, eng.device
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=dev)  # noqa: E731
        self.chrom = eng.cur_chrom
        self.E, self.E_res = put(st.E), put(st.E_res)
        self.cov, self.res = put(pd.new_cov), put(eng.res)
        self.maskf = put(pd.masked_indivs.astype(np.float64))


def _robust_consts(eng) -> RobustConsts:
    c = getattr(eng, "_int_robust", None)
    if c is None or c.chrom != eng.cur_chrom:
        c = eng._int_robust = RobustConsts(eng)
    return c


def robust_batch(g_raw, g_res, E, E_res, cov, res, maskf, scf_denom: float,
                 want_hc4: bool):
    """The HC3/HC4 sandwich quantities of S SNPs at once, float64 on the
    tensors' device (the JAX package's _robust_batch_kernel;
    apply_interaction_tests_qt, Interaction.cpp:109-220). g_raw, g_res
    [S, N]; E [N, Ki]; E_res [N, beg]; cov [N, C]; res, maskf [N, P].
    Returns (scf_i [S, Ki], Dmin [S], Z [S, nc, nc], tau [S, nc, P],
    V3 [S, P, nc, nc], s2 [S, P][, V4 [S, P, nc, nc]])."""
    S, N = g_raw.shape
    iMat = E[None, :, :] * g_raw[:, :, None]  # [S, N, Ki]
    beta = iMat.transpose(1, 2) @ cov  # [S, Ki, C]
    iR = iMat - cov[None] @ beta.transpose(1, 2)
    scf_i = torch.linalg.vector_norm(iR, dim=1) / float(np.sqrt(scf_denom))
    iR = iR / torch.where(scf_i > 0, scf_i, 1.0)[:, None, :]
    M = torch.cat([E_res[None].expand(S, -1, -1), g_res[:, :, None], iR], dim=2)
    nc = M.shape[2]
    D, V = torch.linalg.eigh(M.transpose(1, 2) @ M)
    Z = (V / D[:, None, :]) @ V.transpose(1, 2)
    hvec = ((M @ Z) * M).sum(dim=2)  # [S, N]
    tau = Z @ (M.transpose(1, 2) @ res)  # [S, nc, P]
    e_sq = ((res[None] - M @ tau) * maskf[None]) ** 2  # [S, N, P]
    MM = (M[:, :, :, None] * M[:, :, None, :]).reshape(S, N, nc * nc)

    def sandwich(div):
        core = (MM.transpose(1, 2) @ (e_sq / div[:, :, None]))  # [S, nc*nc, P]
        core = core.permute(0, 2, 1).reshape(S, -1, nc, nc)
        return Z[:, None] @ core @ Z[:, None]

    V3 = sandwich((1.0 - hvec) ** 2)
    outs = (scf_i, D.min(dim=1).values, Z, tau, V3, e_sq.sum(dim=1))
    if want_hc4:
        outs = outs + (sandwich((1.0 - hvec) ** torch.clamp(N * hvec / nc, max=4.0)),)
    return outs


def _robust_block_batched(params, eng, bsnps, idx, blk, result, writers,
                          test_name, out=None):
    """Batched HC3/HC4 sandwich tests for the robust-eligible SNPs of a
    block, in fixed-shape chunks on the engine's device; the rows render
    columnar (_write_int_rows_block) or, with --print-vcov, through the
    per-(SNP, trait) writer on the batch's results."""
    st, pd = eng.interaction, eng.pd
    K = params.ncov_interaction
    beg = params.interaction_istart
    want_hc4 = bool(params.force_hc4)
    N, P = pd.new_cov.shape[0], params.n_pheno
    scf_denom = float(params.n_analyzed - pd.new_cov.shape[1])
    c = _robust_consts(eng)
    S = chunk_size(eng, "robust", 8.0 * N * (4 * P + 12) if _on_card(eng) else N * P / 8,
                   2.5e7)
    scale_fac = getattr(result, "scale_fac", None)
    for chunk, real in _chunks(eng, idx, S):
        outs = robust_batch(blk.dev_rows("raw", chunk), blk.dev_rows("res", chunk),
                            c.E, c.E_res, c.cov, c.res, c.maskf, scf_denom, want_hc4)
        outs = [o[:real].cpu().numpy() for o in outs]
        chunk = chunk[:real]
        scf_i, Dmin, Z, tau, V3, s2 = outs[:6]
        V4 = outs[6] if want_hc4 else None
        nc = Z.shape[1]
        if not params.print_vcov:
            _write_int_rows_block(params, eng, writers, bsnps, chunk, scf_i, Dmin, Z,
                                  tau, V3, s2, V4, result, test_name, beg, K,
                                  scale_fac, out)
            continue
        for si, b in enumerate(chunk):
            if scf_i[si].min() < params.numtol or Dmin[si] < params.numtol:
                continue
            for ph in range(P):
                if (not pd.pheno_pass[ph] or result.ignored_trait[b, ph]
                        or writers[ph] is None):
                    continue
                gscale = pd.scale_Y[ph] * eng.p_sd_yres[ph] / (
                    scale_fac[b] if scale_fac is not None else 1.0)
                iscale = pd.scale_Y[ph] * eng.p_sd_yres[ph] / scf_i[si]
                cscale = pd.scale_Y[ph] * eng.p_sd_yres[ph] / st.scl_E
                if params.no_robust:
                    s2v = s2[si, ph] / (pd.Neff[ph] - params.ncov_analyzed - nc)
                    Vmat = s2v * Z[si]
                else:
                    mac_ph = result.mac_t[b, ph] if result.mac_t is not None else np.inf
                    Vmat = (V4[si, ph]
                            if (params.force_hc4 and mac_ph <= params.rare_mac_inter)
                            else V3[si, ph])
                _write_int_rows(params, eng, writers, bsnps[b], b, ph, tau[si, :, ph],
                                Vmat, beg, K, gscale, iscale, cscale, result, test_name)


def _test_snp_robust(params, eng, snp, b, g_raw, g_res, result, writers, test_name):
    """HC3/model-based sandwich test of one SNP in numpy
    (apply_interaction_tests_qt)."""
    st, pd = eng.interaction, eng.pd
    K = params.ncov_interaction
    beg = params.interaction_istart
    iMat = st.E * g_raw[:, None]
    iMat_res, scf_i = residualize_matrix(iMat, pd.new_cov, params.n_analyzed, params.numtol)
    if iMat_res is None:
        return
    M = np.column_stack([st.E_res, g_res, iMat_res])
    D, V = np.linalg.eigh(M.T @ M)
    if D.min() < params.numtol:
        return
    Z = (V / D[None, :]) @ V.T
    hvec = ((M @ Z) * M).sum(axis=1)
    res = eng.res  # [N, P]
    tau = Z @ (M.T @ res)  # [ncols, P]
    e_sq = ((res - M @ tau) ** 2) * pd.masked_indivs
    hc3 = (1 - hvec) ** 2
    # HC4 divisor for rare variants (--force-hc4, Interaction.cpp:132)
    hc4 = (1 - hvec) ** np.minimum(M.shape[0] * hvec / M.shape[1], 4.0)

    scale_fac = getattr(result, "scale_fac", None)
    for ph in range(params.n_pheno):
        if not pd.pheno_pass[ph] or result.ignored_trait[b, ph] or writers[ph] is None:
            continue
        gscale = pd.scale_Y[ph] * eng.p_sd_yres[ph] / (scale_fac[b] if scale_fac is not None else 1.0)
        iscale = pd.scale_Y[ph] * eng.p_sd_yres[ph] / scf_i
        cscale = pd.scale_Y[ph] * eng.p_sd_yres[ph] / st.scl_E
        if params.no_robust:
            s2 = e_sq[:, ph].sum() / (pd.Neff[ph] - params.ncov_analyzed - M.shape[1])
            Vmat = s2 * Z
        else:
            mac_ph = result.mac_t[b, ph] if result.mac_t is not None else np.inf
            div = hc4 if (params.force_hc4 and mac_ph <= params.rare_mac_inter) else hc3
            Vmat = Z @ (M.T * (e_sq[:, ph] / div)[None, :]) @ M @ Z
        _write_int_rows(params, eng, writers, snp, b, ph, tau[:, ph], Vmat, beg, K,
                        gscale, iscale, cscale, result, test_name)


# ---------------------------------------------------------------------------
# HLM tests (QT, rare variants)
# ---------------------------------------------------------------------------

def _test_snp_hlm(params, eng, snp, b, g_raw, result, writers, test_name):
    """HLM-based test of one SNP in numpy (apply_interaction_tests_HLM)."""
    st, pd = eng.interaction, eng.pd
    h = st.hlm
    K = params.ncov_interaction
    beg = params.interaction_istart
    Ds_all, yres = _np(h.Dinv_sqrt), _np(h.yres)
    # M = [E, G*Vlin] = [E, G, G*E]; E mains dropped in conditional mode
    # (get_interaction_terms HLM branch, Interaction.cpp:66-72)
    parts = ([] if params.gwas_condtl else [st.E]) + [h.Vlin * g_raw[:, None]]
    M = np.column_stack(parts)
    for ph in range(params.n_pheno):
        if not pd.pheno_pass[ph] or result.ignored_trait[b, ph] or writers[ph] is None:
            continue
        Px = _np(h.Px[ph])
        Mm = M * Ds_all[:, ph][:, None]
        Xres = Mm - Px @ (Px.T @ Mm)
        D, V = np.linalg.eigh(Xres.T @ Xres)
        if D.min() < params.numtol:
            return
        Vmat = (V / D[None, :]) @ V.T
        bhat = Vmat @ (Xres.T @ yres[:, ph])
        ones = np.ones(M.shape[1])
        _write_int_rows(params, eng, writers, snp, b, ph, bhat, Vmat, beg, K,
                        1.0, ones[:K], ones[:K], result, test_name)


def hlm_batch(M, Ds, Px, yres):
    """One trait's HLM fits of S SNPs at once (float64 on the tensors'
    device): M [S, N, C] the design [E, G, GxE], Ds [N] the trait's
    Dinv_sqrt, Px [N, q] its whitened covariate basis, yres [N]. Returns
    (Dmin [S], Vmat [S, C, C], bhat [S, C])."""
    Mm = M * Ds[None, :, None]
    Xres = Mm - Px[None] @ (Px.T[None] @ Mm)
    D, V = torch.linalg.eigh(Xres.transpose(1, 2) @ Xres)
    Vmat = (V / D[:, None, :]) @ V.transpose(1, 2)
    bhat = (Vmat @ (Xres.transpose(1, 2) @ yres[:, None]))[..., 0]
    return D.min(dim=1).values, Vmat, bhat


def _hlm_block_batched(params, eng, bsnps, idx, blk, result, writers,
                       test_name, out=None) -> bool:
    """Batched twin of _test_snp_hlm: the per-(SNP, trait) whitened
    projections and eigh solves as [S, N, C] batches on the engine's
    device; the rows render columnar. Keeps the scalar path's abort rule
    (a low-eigenvalue design stops that SNP's remaining traits). With
    --print-vcov on the card each (SNP, trait) goes through the per-row
    writer on the batch's results. Returns False (the caller runs the
    per-SNP loop) where the JAX package does on the CPU."""
    st, pd = eng.interaction, eng.pd
    if not _on_card(eng) and (params.print_vcov or not _batched_rows(eng)):
        return False
    h = st.hlm
    K = params.ncov_interaction
    beg = params.interaction_istart
    tmpl = _int_row_templates(params, st, beg, K, test_name, not _on_card(eng))
    if tmpl is None:
        return False
    term, tests = tmpl
    T, P = len(tests), params.n_pheno
    N = h.Vlin.shape[0]
    C = (0 if params.gwas_condtl else st.E.shape[1]) + h.Vlin.shape[1]
    dev = eng.device
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=dev)  # noqa: E731
    E_t = None if params.gwas_condtl else put(st.E)
    Vlin_t = put(h.Vlin)
    Ds_t, yres_t = (h.Dinv_sqrt, h.yres) if isinstance(h.yres, torch.Tensor) else (
        put(h.Dinv_sqrt), put(h.yres))
    S = chunk_size(eng, "hlm", 8.0 * N * C * (6 if _on_card(eng) else 1))
    ig_all = np.asarray(result.ignored_trait)

    for chunk, real_S in _chunks(eng, idx, S):
        S = len(chunk)
        g = blk.dev_rows("raw", chunk)  # [S, N]
        parts = [] if E_t is None else [E_t[None].expand(S, -1, -1)]
        parts.append(Vlin_t[None, :, :] * g[:, :, None])
        M = torch.cat(parts, dim=2)  # [S, N, C]

        beta_o = np.full((S, P, T), -1.0)
        se_o = np.full((S, P, T), -1.0)
        tstat = np.full((S, P, T), -1.0)
        lp = np.full((S, P, T), -1.0)
        emit = np.zeros((S, P), bool)
        alive = np.ones(S, bool)
        alive[real_S:] = False
        ig = ig_all[chunk][:, :P]
        fits = {}
        for ph in range(P):
            if not pd.pheno_pass[ph] or writers[ph] is None:
                continue
            if not alive.any():
                break
            Px = h.Px[ph] if isinstance(h.Px[ph], torch.Tensor) else put(h.Px[ph])
            Dmin, Vmat, bhat = (x.cpu().numpy() for x in
                                hlm_batch(M, Ds_t[:, ph], Px, yres_t[:, ph]))
            dfail = Dmin < params.numtol
            # an ignored trait is skipped before the eigh in the scalar
            # path, so it cannot abort that SNP
            dfail = dfail & ~ig[:, ph]
            this = alive & ~dfail & ~ig[:, ph]
            alive = alive & ~dfail
            emit[:, ph] = this
            if params.print_vcov:
                fits[ph] = (bhat, Vmat)
                continue
            dg = np.einsum("sjj->sj", Vmat)
            for t in range(T):
                j = term[t]
                if j < 0:
                    continue
                tt = bhat[:, j] ** 2 / dg[:, j]
                tstat[:, ph, t] = tt
                lp[:, ph, t] = chisq_neglog10(tt)
                beta_o[:, ph, t] = bhat[:, j]
                se_o[:, ph, t] = np.sqrt(dg[:, j])
            if K > 1:
                sub = Vmat[:, beg + 1 : beg + 1 + K, beg + 1 : beg + 1 + K]
                bi = bhat[:, beg + 1 : beg + 1 + K]
                tt = np.abs(np.einsum("sk,skl,sl->s", bi, np.linalg.inv(sub), bi))
                tstat[:, ph, T - 2] = tt
                lp[:, ph, T - 2] = chisq_neglog10_df(tt, K)
            sub = Vmat[:, beg : beg + 1 + K, beg : beg + 1 + K]
            bj = bhat[:, beg : beg + 1 + K]
            tt = np.abs(np.einsum("sk,skl,sl->s", bj, np.linalg.inv(sub), bj))
            tstat[:, ph, T - 1] = tt
            lp[:, ph, T - 1] = chisq_neglog10_df(tt, 1 + K)
        if params.print_vcov:
            ones = np.ones(C)
            for si in range(real_S):
                for ph in sorted(fits):
                    if emit[si, ph]:
                        b = chunk[si]
                        _write_int_rows(params, eng, writers, bsnps[b], b, ph,
                                        fits[ph][0][si], fits[ph][1][si], beg, K,
                                        1.0, ones[:K], ones[:K], result, test_name)
            continue
        if out is not None:
            rs = slice(None, real_S)
            rows = chunk[:real_S]
            out["beta"][rows] = beta_o[rs]
            out["se"][rows] = se_o[rs]
            out["chisq"][rows] = tstat[rs]
            out["logp"][rows] = lp[rs]
            out["emit"][rows] = emit[rs]
        elif emit.any():
            _render_int_rows(params, eng, writers, bsnps, chunk, emit, tests, beta_o,
                             se_o, tstat, lp, result)
    return True


# ---------------------------------------------------------------------------
# binary traits
# ---------------------------------------------------------------------------

_ETA_MIN, _ETA_MAX = -30.0, 30.0
_EPS10 = float(10 * np.finfo(np.float64).eps)


def _pvec_t(eta):
    """Tensor twin of glm.get_pvec (same clamping constants)."""
    pi = 1.0 - 1.0 / (torch.exp(torch.clamp(eta, _ETA_MIN, _ETA_MAX)) + 1.0)
    pi = torch.where(eta > _ETA_MAX, 1.0 / (1.0 + _EPS10), pi)
    return torch.where(eta < _ETA_MIN, _EPS10 / (1.0 + _EPS10), pi)


def _xtv(H, v):
    """H' v of each refit: H [Q, N, C], v [Q, N] -> [Q, C]. The products
    of the refits reduce over N with a tiny output, so they run as
    elementwise products and sums (bandwidth-bound), not as batched GEMMs
    or GEMVs, which the card runs several times slower at these shapes."""
    return (H * v[:, :, None]).sum(dim=1)


def _xb(H, b):
    """H b of each refit: [Q, N, C], [Q, C] -> [Q, N]."""
    return (H * b[:, None, :]).sum(dim=2)


def _gram(H, w):
    """H' diag(w) H of each refit: [Q, N, C], [Q, N] -> [Q, C, C]."""
    return ((H * w[:, :, None])[:, :, :, None] * H[:, :, None, :]).sum(dim=1)


def _dev_of(y, pi, maskf):
    nll = torch.where(y == 0, -torch.log(1.0 - pi), -torch.log(pi))
    return 2.0 * (nll * maskf).sum(dim=-1)


def bt_irls_batched(H, y, offset, maskf, niter_max: int, check_hs_dev: bool,
                    tol: float):
    """Batched twin of glm.fit_logistic_irls for Q refit designs sharing
    (y, offset, mask), as masked float64 passes on the tensors' device
    (the JAX package's _bt_irls_kernel): Newton from the working response
    with a min-norm solve, the 5-step deviance line search, the score
    stop and the divergence abort, per-element masks in place of early
    returns (apply_interaction_tests_bt refits, Interaction.cpp:441-664).
    H [Q, N, C]; y, offset, maskf [N]. Returns (beta [Q, C], ok [Q])."""
    Q, N, C = H.shape
    maskb = maskf > 0
    beta = torch.zeros((Q, C), dtype=torch.float64, device=H.device)
    betanew = beta
    eta = offset.expand(Q, N).clone()
    pi = _pvec_t(eta)
    dev_old = _dev_of(y, pi, maskf)
    done = torch.zeros(Q, dtype=torch.bool, device=H.device)
    conv = torch.zeros_like(done)
    small = torch.zeros_like(done)
    diff_dev = torch.full((Q,), float("inf"), dtype=torch.float64, device=H.device)
    rtol = 10.0 * C * float(np.finfo(np.float64).eps)  # jnp.linalg.pinv's default
    i = 0
    while i < niter_max and not bool(done.all()):
        active = ~done
        niter_cur = i + 1
        w = torch.where(maskb, pi * (1.0 - pi), 1.0)
        wzero = (w == 0).any(dim=-1)
        done = done | (active & wzero)
        active = active & ~wzero
        z = torch.where(maskb, eta - offset + (y - pi) / w, 0.0)
        mw = maskf * w
        A = _gram(H, mw)
        rhs = _xtv(H, mw * z)
        bn = (torch.linalg.pinv(A, rtol=rtol) @ rhs[:, :, None])[..., 0]
        # 5-step halving line search: each element keeps its first
        # accepted point; stops once every active element accepted
        t, bcur = 0, bn
        ls_ok = torch.zeros_like(done)
        eta_a, pi_a, dev_a = eta, pi, dev_old
        while t < 5 and not bool((ls_ok | ~active).all()):
            eta_t = offset + _xb(H, bcur)
            pi_t = _pvec_t(eta_t)
            dev_t = _dev_of(y, pi_t, maskf)
            valid = (((pi_t > 0) & (pi_t < 1)) | ~maskb).all(dim=-1) & torch.isfinite(dev_t)
            cond = valid & (dev_t < dev_old) if check_hs_dev else valid
            newly = cond & ~ls_ok
            eta_a = torch.where(newly[:, None], eta_t, eta_a)
            pi_a = torch.where(newly[:, None], pi_t, pi_a)
            dev_a = torch.where(newly, dev_t, dev_a)
            bcur = torch.where((ls_ok | newly)[:, None], bcur, (beta + bcur) / 2.0)
            ls_ok = ls_ok | cond
            t += 1
        done = done | (active & ~ls_ok)
        active = active & ls_ok
        score = _xtv(H, maskf * (y - pi_a))
        smax = score.abs().max(dim=-1).values
        conv_now = active & (smax < tol)
        conv = conv | conv_now
        done = done | conv_now
        betanew = torch.where(active[:, None], bcur, betanew)
        active = active & ~conv_now
        small = small | (active & (niter_cur < 20) & (smax < 1.0))
        diverged = active & small & (niter_cur > 20) & (smax > 5.0)
        done = done | diverged
        active = active & ~diverged
        dd = (dev_a - dev_old).abs() / (0.1 + dev_a.abs())
        diff_dev = torch.where(active, dd, diff_dev)
        beta = torch.where(active[:, None], bcur, beta)
        dev_old = torch.where(active, dev_a, dev_old)
        eta = torch.where(active[:, None], eta_a, eta)
        pi = torch.where(active[:, None], pi_a, pi)
        i += 1
    # not-done elements: converged iff diff_dev in (0, tol)
    tail_ok = ~done & (diff_dev != 0) & (diff_dev < tol)
    ok = conv | tail_ok
    return torch.where((conv | ~done)[:, None], betanew, beta), ok


def bt_design(g, cov, E, E_res, denom: float):
    """The BT refit design of S SNPs on the tensors' device (batched
    residualize_matrix on the orthonormal covariate basis): (H [S, N,
    Ke + 1 + K] = [E_res, G_res, (GxE)_res] scaled, scf_g [S], scf_i
    [S, K])."""
    S, N = g.shape
    gres = g - (g @ cov) @ cov.T
    scf_g = torch.sqrt((gres**2).sum(dim=1)) / float(np.sqrt(denom))
    iMat = E[None, :, :] * g[:, :, None]  # [S, N, K]
    ires = iMat - cov[None] @ (iMat.transpose(1, 2) @ cov).transpose(1, 2)
    scf_i = torch.sqrt((ires**2).sum(dim=1)) / float(np.sqrt(denom))
    H = torch.cat([E_res[None].expand(S, -1, -1),
                   (gres / torch.clamp(scf_g, min=1e-300)[:, None])[:, :, None],
                   ires / torch.clamp(scf_i, min=1e-300)[:, None, :]], dim=2)
    return H, scf_g, scf_i


def bt_trait_fit(H, y, off, mf, niter_max, tol):
    """One trait's refits of S SNPs on the device: the batched IRLS (the
    line search on the deviance, then for the failures again without),
    the weighted Gram's eigh and the model-based covariance. Returns
    tensors (beta [S, C], ok [S], Dmin [S], Vmat [S, C, C], pi, w [S, N])."""
    b1, o1 = bt_irls_batched(H, y, off, mf, niter_max, True, tol)
    if not bool(o1.all()):
        b2, o2 = bt_irls_batched(H, y, off, mf, niter_max, False, tol)
        b1 = torch.where(o1[:, None], b1, b2)
        o1 = o1 | o2
    pi = _pvec_t(off + _xb(H, b1))
    w = torch.where(mf > 0, pi * (1.0 - pi), 0.0)
    D, V = torch.linalg.eigh(_gram(H, w))
    Vmat = (V / D[:, None, :]) @ V.transpose(1, 2)
    return b1, o1, D.min(dim=1).values, Vmat, pi, w


def bt_robust(H, Vmat, pi, w, y, mf):
    """HC3 sandwich of the refits (Interaction.cpp:506-521)."""
    WX = H * torch.sqrt(w)[:, :, None]
    hvec = ((WX @ Vmat) * WX).sum(dim=2)
    r = torch.where(mf > 0, (y - pi) / (1.0 - hvec), 0.0)
    return Vmat @ _gram(H, r**2) @ Vmat


def _bt_block_batched(params, eng, bsnps, idx, blk, result, writers,
                      test_name) -> bool:
    """Batched BT interaction tests for the eligible SNPs of a block: the
    per-(SNP, trait) logistic refits of _test_snp_bt as two masked
    batched IRLS passes and batched eigh / sandwich algebra on the
    engine's device; the rows render columnar. Control flow, skips and
    row order match the scalar path; traits with Firth LRT fallbacks
    (and with --print-vcov on the card, every trait) keep the per-SNP
    writer on the batch's fits. Returns False (the caller runs the
    per-SNP loop) where the JAX package does on the CPU."""
    st, pd, bt = eng.interaction, eng.pd, eng.null_state
    if not _on_card(eng) and (params.print_vcov or not _batched_rows(eng)):
        return False
    beg = params.interaction_istart
    K = params.ncov_interaction
    tmpl = _int_row_templates(params, st, beg, K, test_name, not _on_card(eng))
    if tmpl is None:
        return False
    term, tests = tmpl
    T = len(tests)
    np_ = 1 + K
    lpfirth = -np.log10(params.alpha_pvalue)
    lpbase = -np.log10(0.05)
    P = params.n_pheno
    N, ncov = pd.new_cov.shape
    Ke = st.E_res.shape[1]
    C = Ke + 1 + K
    denom = float(params.n_analyzed - ncov)
    flipped = np.asarray(getattr(eng, "last_flipped", np.zeros(len(bsnps), bool)))
    dev = eng.device
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=dev)  # noqa: E731
    cov_t, E_t, Er_t = put(pd.new_cov), put(st.E), put(st.E_res)
    ncs = len(st.scl_E)
    S = chunk_size(eng, "bt", 8.0 * N * C * (8 if _on_card(eng) else 1))
    mac_all = np.asarray(result.mac_t) if result.mac_t is not None else None
    ig_all = np.asarray(result.ignored_trait)

    for chunk, real_S in _chunks(eng, idx, S):
        S = len(chunk)
        H, scf_g, scf_i = bt_design(blk.dev_rows("raw", chunk), cov_t, E_t, Er_t, denom)
        scf_g, scf_i = scf_g.cpu().numpy(), scf_i.cpu().numpy()
        skip_s = (scf_g < params.numtol) | (scf_i.min(axis=1) < params.numtol)
        bsign = np.where(flipped[chunk], -1.0, 1.0)

        beta_o = np.full((S, P, T), -1.0)
        se_o = np.full((S, P, T), -1.0)
        tstat = np.full((S, P, T), -1.0)
        lp = np.full((S, P, T), -1.0)
        emit = np.zeros((S, P), bool)
        scalar_ph = []  # traits written per SNP (Firth fallbacks, --print-vcov)
        per_ph = {}
        for ph in range(P):
            if not pd.pheno_pass[ph] or writers[ph] is None:
                continue
            maskf = pd.masked_indivs[:, ph].astype(np.float64)
            y_t, mf_t = put(pd.phenotypes_raw[:, ph]), put(maskf)
            b1, o1, Dmin, Vmat, pi, w = bt_trait_fit(
                H, y_t, put(bt.eta_null[:, ph]), mf_t, params.niter_max,
                params.numtol)
            beta, ok = b1.cpu().numpy(), o1.cpu().numpy()
            Dmin, Vm = Dmin.cpu().numpy(), Vmat.cpu().numpy()
            dg = np.einsum("sjj->sj", Vm)
            lp_w = chisq_neglog10(beta[:, beg : beg + np_] ** 2 / dg[:, beg : beg + np_])
            mac_b = mac_all[chunk, ph] if mac_all is not None else np.full(S, np.inf)
            use_rob = np.full(S, bool(params.force_robust))
            if not params.no_robust:
                use_rob |= (mac_b > params.rare_mac_inter) & (lp_w > lpbase).any(axis=1)
            bad = np.zeros(S, bool)
            Vfin = Vm
            if use_rob.any():
                VmR = bt_robust(H, Vmat, pi, w, y_t, mf_t).cpu().numpy()
                dgR = np.einsum("sjj->sj", VmR)
                bad = use_rob & (dgR.min(axis=1) < 0)
                Vfin = np.where(use_rob[:, None, None], VmR, Vm)
                dg = np.where(use_rob[:, None], dgR, dg)
            bhat = beta * bsign[:, None]
            firth_m = np.zeros(S, bool)
            if params.firth:
                tf = np.abs(beta[:, beg + 1 : beg + 1 + K] ** 2 / dg[:, beg + 1 : beg + 1 + K])
                firth_m = (chisq_neglog10(tf) >= lpfirth).any(axis=1)
            usable = (ok & ~skip_s & (Dmin >= params.numtol) & ~bad
                      & ~ig_all[chunk, ph])
            usable[real_S:] = False  # padded rows
            per_ph[ph] = (bhat, Vfin, dg, usable, firth_m)
            if params.print_vcov or (usable & firth_m).any():
                scalar_ph.append(ph)
                continue
            rows_ok = usable & ~firth_m
            if not rows_ok.any():
                continue
            emit[:, ph] = rows_ok
            # per-row scales: E mains 1/scl_E, G 1/scf_g, inter 1/scf_i
            for t in range(T):
                j = term[t]
                if j < 0:
                    continue
                if j < beg:
                    scl = np.full(S, 1.0 / st.scl_E[min(t, ncs - 1)])
                elif j == beg:
                    scl = 1.0 / scf_g
                else:
                    scl = 1.0 / scf_i[:, j - (beg + 1)]
                tt = bhat[:, j] ** 2 / dg[:, j]
                tstat[:, ph, t] = tt
                lp[:, ph, t] = chisq_neglog10(tt)
                beta_o[:, ph, t] = bhat[:, j] * scl
                se_o[:, ph, t] = np.sqrt(dg[:, j]) * scl
            if K > 1:
                sub = Vfin[:, beg + 1 : beg + 1 + K, beg + 1 : beg + 1 + K]
                bi = bhat[:, beg + 1 : beg + 1 + K]
                tt = np.abs(np.einsum("sk,skl,sl->s", bi, np.linalg.inv(sub), bi))
                tstat[:, ph, T - 2] = tt
                lp[:, ph, T - 2] = chisq_neglog10_df(tt, K)
            sub = Vfin[:, beg : beg + 1 + K, beg : beg + 1 + K]
            bj = bhat[:, beg : beg + 1 + K]
            tt = np.abs(np.einsum("sk,skl,sl->s", bj, np.linalg.inv(sub), bj))
            tstat[:, ph, T - 1] = tt
            lp[:, ph, T - 1] = chisq_neglog10_df(tt, 1 + K)

        if emit.any():
            _render_int_rows(params, eng, writers, bsnps, chunk, emit, tests, beta_o,
                             se_o, tstat, lp, result)
        H_np = None
        for ph in scalar_ph:
            # exact row interleaving: per-SNP writes for these traits,
            # on the batch's fits
            bhat, Vfin, dg, usable, firth_m = per_ph[ph]
            y = pd.phenotypes_raw[:, ph]
            mask = pd.masked_indivs[:, ph]
            for si in range(S):
                if not usable[si]:
                    continue
                b = chunk[si]
                if firth_m[si]:
                    if H_np is None:
                        H_np = H.cpu().numpy()
                    _bt_firth_rows(params, eng, writers, bsnps[b], b, ph, H_np[si], y,
                                   mask, beg, K, scf_g[si], scf_i[si], result,
                                   test_name, float(bsign[si]))
                else:
                    _write_int_rows(params, eng, writers, bsnps[b], b, ph, bhat[si],
                                    Vfin[si], beg, K, 1.0 / scf_g[si], 1.0 / scf_i[si],
                                    1.0 / st.scl_E, result, test_name)
    return True


def _test_snp_bt(params, eng, snp, b, g_raw, result, writers, test_name):
    """BT interaction tests of one SNP in numpy: full logistic refit of
    [E, G, GxE] with the null eta as offset, model-based or HC3-robust
    covariance, Firth LRT fallback for significant interactions
    (apply_interaction_tests_bt, Interaction.cpp:441-664)."""
    from .glm import fit_logistic_irls, get_pvec

    st, pd, bt = eng.interaction, eng.pd, eng.null_state
    K = params.ncov_interaction
    beg = params.interaction_istart
    np_ = 1 + K
    flipped = bool(getattr(eng, "last_flipped", np.zeros(b + 1, dtype=bool))[b])

    g_res, scale_g = residualize_matrix(g_raw[:, None], pd.new_cov, params.n_analyzed,
                                        params.numtol)
    if g_res is None:
        return
    iMat = st.E * g_raw[:, None]
    iMat_res, scf_i = residualize_matrix(iMat, pd.new_cov, params.n_analyzed, params.numtol)
    if iMat_res is None:
        return
    H = np.column_stack([st.E_res, g_res[:, 0], iMat_res])
    lpfirth = -np.log10(params.alpha_pvalue)
    lpbase = -np.log10(0.05)
    bsign = -1.0 if flipped else 1.0

    for ph in range(params.n_pheno):
        if not pd.pheno_pass[ph] or result.ignored_trait[b, ph] or writers[ph] is None:
            continue
        y = pd.phenotypes_raw[:, ph]
        mask = pd.masked_indivs[:, ph]
        offset = bt.eta_null[:, ph]

        beta, ok = fit_logistic_irls(y, H, offset, mask, params.niter_max, params.numtol,
                                     True)
        if not ok:
            beta, ok = fit_logistic_irls(y, H, offset, mask, params.niter_max,
                                         params.numtol, False)
        if not ok:
            continue
        pi = get_pvec(offset + H @ beta)
        w = np.where(mask, pi * (1 - pi), 0.0)
        WX = H * np.sqrt(w)[:, None]
        D, V = np.linalg.eigh(WX.T @ WX)
        if D.min() < params.numtol:
            continue
        Vmat = (V / D[None, :]) @ V.T

        # robust sandwich when a main/interaction effect is significant
        # and the variant is not too rare (Interaction.cpp:506-521)
        mac_b = result.mac_t[b, ph] if result.mac_t is not None else np.inf
        use_robust = params.force_robust
        if not params.no_robust and mac_b > params.rare_mac_inter:
            for j in range(beg, beg + np_):
                t = beta[j] ** 2 / Vmat[j, j]
                if chisq_neglog10(np.array([t]))[0] > lpbase:
                    use_robust = True
        if use_robust:
            hvec = ((WX @ Vmat) * WX).sum(axis=1)
            r = np.where(mask, (y - pi) / (1 - hvec), 0.0)
            Vr = H.T @ (H * (r**2)[:, None])
            Vmat = Vmat @ Vr @ Vmat
            if np.diag(Vmat).min() < 0:
                continue
        bhat = beta * bsign

        # Firth gate: any interaction Wald p below alpha threshold
        use_firth = False
        if params.firth:
            for j in range(beg + 1, beg + 1 + K):
                t = abs(beta[j] ** 2 / Vmat[j, j])
                if chisq_neglog10(np.array([t]))[0] >= lpfirth:
                    use_firth = True
        if use_firth:
            _bt_firth_rows(params, eng, writers, snp, b, ph, H, y, mask,
                           beg, K, scale_g[0], scf_i, result, test_name, bsign)
            continue
        _write_int_rows(params, eng, writers, snp, b, ph, bhat, Vmat, beg, K,
                        1.0 / scale_g[0], 1.0 / scf_i, 1.0 / st.scl_E, result, test_name)


def _bt_firth_rows(params, eng, writers, snp, b, ph, H, y, mask, beg, K,
                   scale_g, scf_i, result, test_name, bsign):
    """Firth LRT fallback (apply_interaction_tests_firth,
    Interaction.cpp:664-864): full fit + one reduced fit per test, on
    the host (models/firth.fit_firth_multi)."""
    from . import firth as firth_mod

    st, bt = eng.interaction, eng.null_state
    np_ = 1 + K
    ncols = H.shape[1]
    offset = bt.firth_offset[:, ph] if params.firth_approx else bt.eta_null[:, ph]

    # full model
    beta_f, se_f, dev, dev0, okf = firth_mod.fit_firth_multi(
        y, H, offset, mask, None, None, params.maxstep,
        params.niter_max_firth, 2.5e-4, comp_lrt=True,
    )
    if not okf:
        return

    def reduced_drop(j, warm):
        """LRT fit excluding column j (swap-to-last trick,
        Interaction.cpp:769-780): penalty keeps all columns."""
        order = [c for c in range(ncols) if c != j] + [j]
        b0 = warm[order].copy()
        b0[-1] = 0.0
        _b, _s, dev_s, _d0, ok = firth_mod.fit_firth_multi(
            y, H[:, order], offset, mask, b0, ncols - 1, params.maxstep,
            params.niter_max_firth, 2.5e-4,
        )
        return dev_s, ok

    rows = []
    evar = st.evar_name
    # E main effects (betas from the full fit, no p-value)
    for j in range(beg):
        if st.is_cat:
            sfx = f"-INT_{evar}={st.lvl_names[j]}"
        elif params.int_add_esq and j != 0:
            sfx = f"-INT_{evar}^2"  # E^2 main effect (Interaction.cpp:738)
        else:
            sfx = f"-INT_{evar}"
        rows.append((sfx, beta_f[j] / st.scl_E[j], se_f[j] / st.scl_E[j], -1.0, -1.0))

    # joint (1+K df): null = E-only (or penalized dev at 0 when beg==0)
    if beg > 0:
        _b, _s, dev_j, _d0, okj = firth_mod.fit_firth_multi(
            y, H, offset, mask, None, beg, params.maxstep_null,
            params.niter_max_firth_null, 2.5e-4,
        )
        t_joint = (dev_j - dev) if okj else -1.0
    else:
        t_joint = dev0 - dev
    joint_row = None
    if t_joint >= 0:
        lp = float(chisq_neglog10_df(np.array([t_joint]), np_)[0])
        joint_row = (f"-INT_{np_}DF", None, None, t_joint, lp)

    # marginal G LRT
    dev_m, okm = reduced_drop(beg, beta_f)
    if not okm:
        return
    t = dev_m - dev
    if t < 0:
        return
    se_val = abs(beta_f[beg]) / np.sqrt(t) if (params.firth_se and t > 0) else se_f[beg]
    lp = float(chisq_neglog10(np.array([t]))[0])
    rows.append(("-INT_SNP", bsign * beta_f[beg] / scale_g, se_val / scale_g, t, lp))

    if K > 1:
        for j in range(K):
            jj = beg + 1 + j
            rows.append((f"-INT_SNPx{evar}={st.lvl_names[j]}",
                         bsign * beta_f[jj] / scf_i[j], se_f[jj] / scf_i[j], -1.0, -1.0))
        b0 = beta_f.copy()
        b0[beg + 1 :] = 0.0
        _b, _s, dev_i, _d0, oki = firth_mod.fit_firth_multi(
            y, H, offset, mask, b0, beg + 1, params.maxstep,
            params.niter_max_firth, 2.5e-4,
        )
        if not oki:
            return
        t = dev_i - dev
        if t < 0:
            return
        lp = float(chisq_neglog10_df(np.array([t]), np_ - 1)[0])
        rows.append((f"-INT_SNPx{evar}", None, None, t, lp))
    else:
        dev_i, oki = reduced_drop(ncols - 1, beta_f)
        if not oki:
            return
        t = dev_i - dev
        if t < 0:
            return
        jj = beg + 1
        se_val = abs(beta_f[jj]) / np.sqrt(t) if (params.firth_se and t > 0) else se_f[jj]
        lp = float(chisq_neglog10(np.array([t]))[0])
        sfx = f"-INT_SNPx{evar}" + (f"={st.lvl_names[0]}" if st.is_cat else "")
        rows.append((sfx, bsign * beta_f[jj] / scf_i[0], se_val / scf_i[0], t, lp))
    if joint_row is not None:
        rows.append(joint_row)
    _write_rows(params, writers[ph], snp, b, ph, rows, result, test_name)


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def _int_row_templates(params, st, beg, K, test_name, limit=True):
    """The fixed per-SNP row templates of _write_int_rows: (term indices,
    TEST strings); term -1 = K-df joint, -2 = (1+K)-df joint. With
    `limit` (the CPU's routing), None when a TEST string exceeds the JAX
    package's native formatter's 40 bytes, where it falls back to the
    per-SNP loops; rows rendered in Python have no such limit."""
    evar = st.evar_name
    sfx, term = [], []
    for j in range(beg):
        if st.is_cat:
            sfx.append(f"-INT_{evar}={st.lvl_names[j]}")
        elif params.int_add_esq and j != 0:
            sfx.append(f"-INT_{evar}^2")
        else:
            sfx.append(f"-INT_{evar}")
        term.append(j)
    sfx.append("-INT_SNP")
    term.append(beg)
    if K > 1:
        for j in range(K):
            sfx.append(f"-INT_SNPx{evar}={st.lvl_names[j]}")
            term.append(beg + 1 + j)
        sfx.append(f"-INT_SNPx{evar}")
        term.append(-1)  # joint over the K interaction terms
    else:
        sfx.append(f"-INT_SNPx{evar}")
        term.append(beg + 1)
    sfx.append(f"-INT_{1+K}DF")
    term.append(-2)  # joint df=1+K
    tests = [test_name + s for s in sfx]
    if limit and max(len(t) for t in tests) > 40:
        return None
    return term, tests


def _write_int_rows_block(params, eng, writers, bsnps, chunk, scf_i, Dmin, Z, tau,
                          V3, s2, V4, result, test_name, beg, K, scale_fac, out=None):
    """Columnar twin of the per-(SNP, trait) _write_int_rows loop for the
    batched robust path: row statistics vectorized over (SNP, trait, row
    template), rendered SNP-major, template-minor in each trait's file
    (the scalar loop's order), or left in `out` (a mixed block)."""
    st, pd = eng.interaction, eng.pd
    P = params.n_pheno
    S = len(chunk)
    keep_s = ~((scf_i.min(axis=1) < params.numtol) | (Dmin < params.numtol))
    if not keep_s.any():
        return
    # Vsel [S, P, nc, nc]: model-based / HC3 / HC4 per (SNP, trait),
    # mirroring the scalar selection
    nc = Z.shape[1]
    if params.no_robust:
        denom = pd.Neff - params.ncov_analyzed - nc  # [P]
        Vsel = (s2 / denom[None, :])[:, :, None, None] * Z[:, None, :, :]
    else:
        Vsel = V3
        if params.force_hc4 and V4 is not None:
            mac = (result.mac_t[chunk] if result.mac_t is not None
                   else np.full((S, P), np.inf))
            rare = mac <= params.rare_mac_inter
            Vsel = np.where(rare[:, :, None, None], V4, V3)
    diag = np.einsum("spjj->spj", Vsel)  # [S, P, nc]
    term, tests = _int_row_templates(params, st, beg, K, test_name, limit=False)
    T = len(tests)

    # scales [S, P, T] (joint rows carry the -1 NA sentinels)
    scale_Yp = np.asarray(pd.scale_Y) * np.asarray(eng.p_sd_yres)  # [P]
    sf_g = np.asarray(scale_fac)[chunk] if scale_fac is not None else np.ones(S)
    beta_o = np.full((S, P, T), -1.0)
    se_o = np.full((S, P, T), -1.0)
    tstat = np.full((S, P, T), -1.0)
    lp = np.full((S, P, T), -1.0)
    ncs = len(st.scl_E)
    for t in range(T):
        j = term[t]
        if j < 0:
            continue
        if j < beg:
            scl = (scale_Yp / st.scl_E[min(t, ncs - 1)])[None, :]
        elif j == beg:
            scl = scale_Yp[None, :] / sf_g[:, None]
        else:
            scl = scale_Yp[None, :] / scf_i[:, j - (beg + 1)][:, None]
        tt = tau[:, j, :] ** 2 / diag[:, :, j]
        tstat[:, :, t] = tt
        lp[:, :, t] = chisq_neglog10(tt)
        beta_o[:, :, t] = tau[:, j, :] * scl
        se_o[:, :, t] = np.sqrt(diag[:, :, j]) * scl
    if K > 1:
        sub = Vsel[:, :, beg + 1 : beg + 1 + K, beg + 1 : beg + 1 + K]
        bi = tau[:, beg + 1 : beg + 1 + K, :].transpose(0, 2, 1)  # [S, P, K]
        tt = np.abs(np.einsum("spk,spkl,spl->sp", bi, np.linalg.inv(sub), bi))
        tstat[:, :, T - 2] = tt
        lp[:, :, T - 2] = chisq_neglog10_df(tt, K)
    sub = Vsel[:, :, beg : beg + 1 + K, beg : beg + 1 + K]
    bj = tau[:, beg : beg + 1 + K, :].transpose(0, 2, 1)
    tt = np.abs(np.einsum("spk,spkl,spl->sp", bj, np.linalg.inv(sub), bj))
    tstat[:, :, T - 1] = tt
    lp[:, :, T - 1] = chisq_neglog10_df(tt, 1 + K)

    emit = keep_s[:, None] & ~np.asarray(result.ignored_trait[chunk][:, :P], bool)
    if out is not None:
        out["beta"][chunk] = beta_o
        out["se"][chunk] = se_o
        out["chisq"][chunk] = tstat
        out["logp"][chunk] = lp
        out["emit"][chunk] = emit
        return
    _render_int_rows(params, eng, writers, bsnps, chunk, emit, tests, beta_o, se_o,
                     tstat, lp, result)


def _render_int_rows(params, eng, writers, bsnps, chunk, emit, tests, beta_o, se_o,
                     tstat, lp, result):
    """Render precomputed interaction row statistics in Python, the bytes
    of the JAX package's native batch formatter. emit [S, P]: which (SNP,
    trait) row groups to write; beta_o/se_o/tstat/lp [S, P, T] (NA
    sentinels -1); tests: the T TEST strings. Rows of each trait's file go
    SNP-major, template-minor (the scalar loop's order)."""
    pd = eng.pd
    S, P, T = beta_o.shape
    info_t = result.info_t
    for ph in range(P):
        if not pd.pheno_pass[ph] or writers[ph] is None:
            continue
        sel = np.flatnonzero(emit[:, ph])
        if not len(sel):
            continue
        parts = []
        for si in sel:
            b = chunk[si]
            snp = bsnps[b]
            af, n = result.af_t[b, ph], int(result.ns_t[b, ph])
            info = ((info_t[b, ph] if info_t is not None else 1.0)
                    if params.dosage_mode else None)
            for t in range(T):
                parts.append(sumstat_line_single(
                    params, snp, tests[t], af, info, n, beta_o[si, ph, t],
                    se_o[si, ph, t], tstat[si, ph, t], lp[si, ph, t], True))
        writers[ph].write("".join(parts))


def _write_rows(params, fh, snp, b, ph, rows, result, test_name):
    """(suffix, beta, se, chisq, logp) rows of one (SNP, trait)."""
    info = ((result.info_t[b, ph] if result.info_t is not None else 1.0)
            if params.dosage_mode else None)
    fh.write("".join(
        sumstat_line_single(
            params, snp, test_name + sfx, result.af_t[b, ph], info,
            int(result.ns_t[b, ph]),
            beta if beta is not None else -1.0, se if se is not None else -1.0,
            chisq, lp, True)
        for sfx, beta, se, chisq, lp in rows))


def _write_int_rows(params, eng, writers, snp, b, ph, bhat, Vmat, beg, K,
                    gscale, iscale, cscale, result, test_name):
    """The rows of one (SNP, trait) from its coefficients and covariance:
    E main effects, the marginal G, the interaction terms (with a K-df
    joint when K > 1) and the (1+K)-df joint; with --print-vcov the
    coefficient covariance on the output scale to
    <out>_<trait>_<E>_<SNP>.vcov (Interaction.cpp:604-615)."""
    pd = eng.pd
    iscale = np.atleast_1d(iscale)
    cscale = np.atleast_1d(cscale)
    if params.print_vcov:
        sc = np.concatenate([
            np.broadcast_to(cscale, (beg,)), [np.atleast_1d(gscale)[0]],
            np.broadcast_to(iscale, (K,)),
        ])
        Vout = Vmat[: beg + 1 + K, : beg + 1 + K] * sc[:, None] * sc[None, :]
        path = (f"{params.out_prefix}_{pd.pheno_names[ph]}_"
                f"{eng.interaction.evar_name}_{snp.ID}.vcov")
        with open(path, "w") as fh:
            for row in Vout:
                fh.write(" ".join(f"{v:.6g}" for v in row) + "\n")
    rows = []
    evar = eng.interaction.evar_name
    # main effect(s) of E
    for j in range(beg):
        t = bhat[j] ** 2 / Vmat[j, j]
        se = np.sqrt(Vmat[j, j]) * cscale[min(j, len(cscale) - 1)]
        lp = float(chisq_neglog10(np.array([t]))[0])
        if eng.interaction.is_cat:
            sfx = f"-INT_{evar}={eng.interaction.lvl_names[j]}"
        elif params.int_add_esq and j != 0:
            sfx = f"-INT_{evar}^2"  # E^2 main effect (Interaction.cpp:624)
        else:
            sfx = f"-INT_{evar}"
        rows.append((sfx, bhat[j] * cscale[min(j, len(cscale) - 1)], se, t, lp))
    # marginal G
    t = bhat[beg] ** 2 / Vmat[beg, beg]
    se = np.sqrt(Vmat[beg, beg]) * gscale
    rows.append(("-INT_SNP", bhat[beg] * gscale, se, t,
                 float(chisq_neglog10(np.array([t]))[0])))
    # interaction terms
    if K > 1:
        for j in range(K):
            jj = beg + 1 + j
            t = bhat[jj] ** 2 / Vmat[jj, jj]
            se = np.sqrt(Vmat[jj, jj]) * iscale[j]
            rows.append((f"-INT_SNPx{evar}={eng.interaction.lvl_names[j]}",
                         bhat[jj] * iscale[j], se, t,
                         float(chisq_neglog10(np.array([t]))[0])))
        Vinv = np.linalg.inv(Vmat[beg + 1 :, beg + 1 :][:K, :K])
        bi = bhat[beg + 1 : beg + 1 + K]
        t = abs(bi @ Vinv @ bi)
        lp = float(chisq_neglog10_df(np.array([t]), K)[0])
        rows.append((f"-INT_SNPx{evar}", None, None, t, lp))
    else:
        jj = beg + 1
        t = bhat[jj] ** 2 / Vmat[jj, jj]
        se = np.sqrt(Vmat[jj, jj]) * iscale[0]
        rows.append((f"-INT_SNPx{evar}", bhat[jj] * iscale[0], se, t,
                     float(chisq_neglog10(np.array([t]))[0])))
    # joint df=1+K
    sub = Vmat[beg : beg + 1 + K, beg : beg + 1 + K]
    bj = bhat[beg : beg + 1 + K]
    t = abs(bj @ np.linalg.inv(sub) @ bj)
    lp = float(chisq_neglog10_df(np.array([t]), 1 + K)[0])
    rows.append((f"-INT_{1+K}DF", None, None, t, lp))
    _write_rows(params, writers[ph], snp, b, ph, rows, result, test_name)
