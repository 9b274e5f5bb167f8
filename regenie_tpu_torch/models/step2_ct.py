"""Step 2 on count traits (the port's copy of regenie_tpu/models/step2_ct.py):
the Poisson null fit per chromosome on the host, in numpy float64.

Reference: compute_res_count (Data.cpp:2462), fit_null_poisson
(Step1_Models.cpp:225), compute_score_ct (Step2_Models.cpp:560). The
score test is the binary traits' (models/step2_bt.score_block) with the
weights W = mu and no Firth or SPA correction.
"""

from __future__ import annotations

import numpy as np

from ..config import Params
from ..io.pheno import PhenoData, get_basis
from .glm import fit_poisson_irls
from .step2_bt import BTChromState


def prep_chromosome(params: Params, pd: PhenoData, blups: np.ndarray, log) -> BTChromState:
    """Refit the null Poisson model with the LOCO offset per trait, a trait
    at a time, and build the score test's null state from it."""
    N, P = pd.phenotypes_raw.shape
    st = BTChromState()
    st.blups = blups
    st.res = np.zeros((N, P))
    st.Y_hat = np.zeros((N, P))
    st.gamma_sqrt = np.ones((N, P))
    st.gamma_sqrt_mask = np.zeros((N, P))
    st.X_gamma = [None] * P
    st.allow_correction = False

    for ph in range(P):
        if not pd.pheno_pass[ph]:
            continue
        y = pd.phenotypes_raw[:, ph]
        mask = pd.masked_indivs[:, ph]
        offset = blups[:, ph] * mask
        beta, ok = fit_poisson_irls(
            y, pd.new_cov, offset, mask, params.niter_max, params.numtol
        )
        if not ok:
            log(f"WARNING: poisson regression did not converge for '{pd.pheno_names[ph]}'")
            pd.pheno_pass[ph] = False
            continue
        eta = offset + pd.new_cov @ beta
        mu = np.where(mask, np.exp(np.clip(eta, -30, 30)), 0.0)
        gs = np.where(mask, np.sqrt(mu), 1.0)
        st.Y_hat[:, ph] = mu
        st.gamma_sqrt[:, ph] = gs
        st.gamma_sqrt_mask[:, ph] = gs * mask
        XW = pd.new_cov * st.gamma_sqrt_mask[:, ph][:, None]
        XW, _ = get_basis(XW, params)
        st.X_gamma[ph] = XW
        st.res[:, ph] = np.where(mask, (y - mu) / gs, 0.0)
    return st
