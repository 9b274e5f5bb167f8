"""Step-2 QT score-test tail (the port's copy of finalize_qt from
regenie_tpu/models/step2.py; compute_score_qt, Step2_Models.cpp:343)."""

from __future__ import annotations

import numpy as np


def finalize_qt(stats, denum, scale_fac, scf_sv, flipped=None):
    """Host-side: effect sizes/SE/chisq on the raw genotype scale
    (compute_score_qt tail, Step2_Models.cpp:440-460).

    stats, denum: [B,P]; scale_fac: [B] (gsc); scf_sv: [P].
    Returns (bhat, se, chisq) each [B,P].
    """
    stats = np.asarray(stats)
    denum = np.asarray(denum)
    gsc = np.asarray(scale_fac)[:, None]
    bhat = stats * scf_sv[None, :] / (np.sqrt(denum) * gsc)
    if flipped is not None:
        bhat = np.where(flipped[:, None], -bhat, bhat)
    se = np.abs(bhat / stats)
    chisq = stats**2
    return bhat, se, chisq
