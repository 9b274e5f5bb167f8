"""Interaction tests on binary traits in the port's Step 2 against
`python -m regenie_tpu`, both on the CPU in this process, on the BED of
tests/test_torch_interaction.py with its traits thresholded (N = 900):

- the per-SNP solver (the CPU's default route in both packages: the
  numpy logistic IRLS a (SNP, trait)) with and without --firth --approx
  (the Firth LRT rows) and --spa: every row within rel 1e-9 in order;
- the batched IRLS (REGENIE_TPU_BATCH_INT=1 on both sides: two masked
  float64 passes a chunk and trait, bt_irls_batched against the JAX
  package's _bt_irls_kernel) on --interaction C1, a categorical E with
  --no-condtl (E^2 main effects for BT), and --firth --approx: every row
  within rel 1e-9 but those of a (SNP, trait) whose refit is decided by
  rounding. At the optimum the line search compares deviances equal up to
  rounding (dev_t < dev_old), so either package may accept the last
  Newton step or reject it and finish in the unchecked pass: two
  converged answers one sub-tolerance step apart (~1e-8). A refit whose
  coefficients leave 1e-12 of the JAX package's must be witnessed: both
  converged, their deviances within 1e-13 of each other on the JAX
  package's inputs and both scores within 10 x the IRLS tolerance; a
  convergence flag that differs must flip in the JAX package's own kernel
  with the batch around the refit or under 1e-15 perturbations of its
  inputs (ROADMAP.md §3). Witnessed refits are few (at most 5%), and
  their rows may differ.

One test needs an NVIDIA GPU (marker `cuda`): bt_irls_batched on the card
against the CPU. On the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_interaction_bt.py
"""

import os

import numpy as np
import pytest

from chip_smoke import write_bt_table
from test_torch_interaction import add_cat_covariate, rows_close, run_jax, run_port

from chip_smoke import write_dataset

N = 900
WITNESS_DRAWS = 8
WITNESS_REL = 1e-15
DEV_REL = 1e-13  # the deviance sum's own rounding at N = 900 is ~1e-13


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_interaction_bt"))
    g = write_dataset(d, seed=5, N=N, P=3, n_inc=1, n_cov=3, n_remove=5,
                      chroms=((1, 120), (2, 80)))
    Y = np.genfromtxt(f"{d}/pheno.txt", skip_header=1, missing_values="NA")[:, 2:]
    write_bt_table(f"{d}/pheno_bt.txt", Y, seed=3, prev=(0.2, 0.4), n_inc=1)
    add_cat_covariate(d)
    return d, g


def _argv(d, g, flags):
    cov = [] if "--covarFile" in flags else ["--covarFile", f"{d}/covar.txt"]
    return ["--step", "2", "--bed", g, "--phenoFile", f"{d}/pheno_bt.txt", "--bt", *cov,
            "--remove", f"{d}/remove.txt", "--ignore-pred", "--bsize", "64", *flags]


PER_SNP = {
    "plain": ["--interaction", "C1"],
    "firth": ["--interaction", "C1", "--firth", "--approx"],
    "spa": ["--interaction", "C1", "--spa"],
}


@pytest.mark.parametrize("scenario", sorted(PER_SNP))
def test_bt_per_snp_matches_jax(data, scenario, monkeypatch):
    """The per-SNP route (both packages' CPU default) within rel 1e-9 in
    order, with the interaction rows present (and with --firth --approx
    some Firth LRT rows: a TEST whose BETA prints with an NA SE-less
    joint row is not enough to tell, so the count of INT rows is held)."""
    d, g = data
    flags = PER_SNP[scenario]
    argv = _argv(d, g, flags)
    jx, pt = f"{d}/jx_{scenario}", f"{d}/pt_{scenario}"
    run_jax(argv + ["--out", jx], monkeypatch)
    log = run_port(argv + ["--out", pt], monkeypatch)
    assert " * interaction tests: robust 0 SNPs" in log and "BT 200 SNPs" in log
    n = sum(rows_close(f"{pt}_Y{p}.regenie", f"{jx}_Y{p}.regenie") for p in (2, 3))
    rows = open(f"{pt}_Y2.regenie").read()
    assert n > 2 * 200 and "ADD-INT_SNPxC1" in rows and "ADD-INT_2DF" in rows


class _Recorder:
    """The refits of a run: each call's (block's SNP IDs, trait,
    check_hs_dev, H, y, offset, mask, beta, ok), in call order."""

    def __init__(self):
        self.calls = []
        self.ctx = None


def _record_port(monkeypatch, rec):
    from regenie_tpu_torch.models import interaction as pint

    orig_irls, orig_block = pint.bt_irls_batched, pint._bt_block_batched

    def block(params, eng, bsnps, idx, *a, **k):
        rec.ctx = ([bsnps[b].ID for b in idx], eng.pd)
        return orig_block(params, eng, bsnps, idx, *a, **k)

    def irls(H, y, off, mf, niter, check, tol):
        b, ok = orig_irls(H, y, off, mf, niter, check, tol)
        ids, pd = rec.ctx
        yn = y.cpu().numpy()
        ph = next(pd.pheno_names[p] for p in range(len(pd.pheno_names))
                  if np.array_equal(pd.phenotypes_raw[:, p], yn))
        rec.calls.append((ids, ph, check, b.cpu().numpy(), ok.cpu().numpy()))
        return b, ok

    monkeypatch.setattr(pint, "bt_irls_batched", irls)
    monkeypatch.setattr(pint, "_bt_block_batched", block)


def _record_jax(monkeypatch, rec):
    from regenie_tpu.models import interaction as jint

    orig = rec.orig = jint._bt_irls_kernel

    def make(C, niter, check, tol):
        run = orig(C, niter, check, tol)

        def call(H, y, off, mf):
            b, ok = run(H, y, off, mf)
            rec.calls.append((check, np.asarray(H), np.asarray(y), np.asarray(off),
                              np.asarray(mf), np.asarray(b), np.asarray(ok),
                              (C, niter, tol)))
            return b, ok

        return call

    monkeypatch.setattr(jint, "_bt_irls_kernel", make)


def _finals(calls, key):
    """Per first-pass call, the final (beta, ok) of each element: the
    deviance-checked pass, and where it failed the unchecked one."""
    out = []
    for i, c in enumerate(calls):
        if not key(c):
            continue
        b, ok = key(c, "b"), key(c, "ok")
        nxt = calls[i + 1] if i + 1 < len(calls) else None
        if nxt is not None and not key(nxt) and not ok.all():
            b = np.where(ok[:, None], b, key(nxt, "b"))
            ok = ok | key(nxt, "ok")
        out.append((c, b, ok))
    return out


def _jax_two_pass(kernel, cfg, H, y, off, mf):
    """The JAX package's two IRLS passes on one input (its kernel)."""
    import jax

    C, niter, tol = cfg
    with jax.enable_x64(True):
        b, ok = (np.asarray(x) for x in kernel(C, niter, True, tol)(H, y, off, mf))
        if not ok.all():
            b2, ok2 = (np.asarray(x) for x in
                       kernel(C, niter, False, tol)(H, y, off, mf))
            b = np.where(ok[:, None], b, b2)
            ok = ok | ok2
    return b, ok


def _dev_score(H, y, off, mf, b):
    """The logistic deviance and the largest |score| of coefficients b."""
    from regenie_tpu_torch.models.glm import get_pvec

    pi = get_pvec(off + H @ b)
    nll = np.where(y == 0, -np.log(1 - pi), -np.log(pi))
    return 2 * (nll * mf).sum(), np.abs(H.T @ (mf * (y - pi))).max()


def _witnessed(port_calls, jax_calls, kernel):
    """Compare the port's refits with the JAX package's and witness every
    one that leaves 1e-12 or flips its flag. A refit is witnessed when
    both converged to optima the line search cannot tell apart (their
    deviances within DEV_REL of each other on the JAX package's inputs,
    both scores within 10 x the IRLS tolerance), or, where a flag differs,
    when the JAX package's own flag flips with the batch around it (the
    refit alone, the chunk reversed) or under WITNESS_DRAWS perturbations
    of its inputs at WITNESS_REL. Returns ({trait name: {SNP IDs}} witnessed,
    refits compared); raises on an unwitnessed difference."""
    pf = _finals(port_calls, lambda c, k=None: c[2] if k is None else
                 {"b": c[3], "ok": c[4]}[k])
    jf = _finals(jax_calls, lambda c, k=None: c[0] if k is None else
                 {"b": c[5], "ok": c[6]}[k])
    assert len(pf) == len(jf) > 0
    skip, n = {}, 0
    for (pc, pb, pok), (jc, jb, jok) in zip(pf, jf):
        ids, ph = pc[0], pc[1]
        S = len(ids)
        n += S
        _, H, y, off, mf = jc[:5]
        C, niter, tol = jc[7]
        gap = np.abs(pb - jb[:S]).max(axis=1)
        bad = (gap > 1e-12 * (1 + np.abs(jb[:S]).max(axis=1))) | (pok != jok[:S])
        flip = None
        for q in np.flatnonzero(bad):
            if pok[q] and jok[q]:
                dp, sp = _dev_score(H[q], y, off, mf, pb[q])
                dj, sj = _dev_score(H[q], y, off, mf, jb[q])
                ok_w = abs(dp - dj) <= DEV_REL * dj and max(sp, sj) <= 10 * tol
            else:
                if flip is None:
                    flip = np.zeros(len(jb), bool)
                    rng = np.random.default_rng(7)
                    draws = [H[::-1].copy()] + [
                        H * (1 + WITNESS_REL * rng.standard_normal(H.shape))
                        for _ in range(WITNESS_DRAWS)]
                    for i, Hp in enumerate(draws):
                        okp = _jax_two_pass(kernel, jc[7], Hp, y, off, mf)[1]
                        flip |= (okp[::-1] if i == 0 else okp) != jok
                single = _jax_two_pass(kernel, jc[7], H[q : q + 1], y, off, mf)[1][0]
                ok_w = flip[q] or single != jok[q]
            assert ok_w, (ids[q], ph, gap[q], pok[q], jok[q])
            skip.setdefault(ph, set()).add(ids[q])
    return skip, n


BATCHED = {
    "c1": ["--interaction", "C1"],
    "cat_no_condtl": ["--interaction", "E3", "--catCovarList", "E3", "--covarFile",
                      "@CAT", "--no-condtl"],
    "c1_no_condtl_firth": ["--interaction", "C1", "--no-condtl", "--firth", "--approx"],
}


@pytest.mark.parametrize("scenario", sorted(BATCHED))
def test_bt_batched_matches_jax(data, scenario, monkeypatch):
    """The batched IRLS route on both sides (REGENIE_TPU_BATCH_INT=1):
    refits within 1e-12 of the JAX package's or witnessed as decided by
    rounding; every row of an unwitnessed (SNP, trait) within rel 1e-9 in
    order."""
    d, g = data
    flags = [f.replace("@CAT", f"{d}/covar_cat.txt") for f in BATCHED[scenario]]
    argv = _argv(d, g, flags)
    env = (("REGENIE_TPU_BATCH_INT", "1"),)
    jx, pt = f"{d}/jxb_{scenario}", f"{d}/ptb_{scenario}"
    jrec, prec = _Recorder(), _Recorder()
    _record_jax(monkeypatch, jrec)
    run_jax(argv + ["--out", jx], monkeypatch, env)
    _record_port(monkeypatch, prec)
    log = run_port(argv + ["--out", pt], monkeypatch, env)
    bt_n = int(log.split(" * interaction tests:")[1].split("BT ")[1].split()[0])
    assert bt_n == 200
    skip, n = _witnessed(prec.calls, jrec.calls, jrec.orig)
    n_skip = sum(len(v) for v in skip.values())
    print(f"{scenario}: {n} refits, witnessed {n_skip}: {skip}")
    assert n_skip <= 0.05 * n
    rows = 0
    for p in (2, 3):
        rows += rows_close(f"{pt}_Y{p}.regenie", f"{jx}_Y{p}.regenie",
                           skip=skip.get(f"Y{p}"))
    assert rows > 2 * 150


@pytest.mark.cuda
def test_bt_irls_card_matches_cpu():
    """bt_design and bt_trait_fit (the two IRLS passes) on the card against
    the CPU (64 SNPs, N = 2,000): where both converged, coefficients
    within 1e-6 of their magnitude (one sub-tolerance Newton step apart
    at most, as the deviance test at the optimum decides by rounding);
    the convergence flags equal on all but 5% of the refits."""
    import torch

    from regenie_tpu_torch.models import interaction as pint

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(1)
    n, S = 2000, 64
    cov = np.linalg.qr(np.column_stack([np.ones(n), rng.standard_normal((n, 3))]))[0]
    E = rng.standard_normal((n, 1))
    g = rng.binomial(2, 0.3, size=(S, n)).astype(float)
    off = cov @ rng.standard_normal(4) * 0.3 - 1.0
    y = (rng.random(n) < 1 / (1 + np.exp(-off))).astype(float)
    mf = np.ones(n)
    got = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        H, _, _ = pint.bt_design(t(g), t(cov), t(E), t(np.zeros((n, 0))), n - 4.0)
        b, ok, *_ = pint.bt_trait_fit(H, t(y), t(off), t(mf), 30, 1e-6)
        got[dev] = (b.cpu().numpy(), ok.cpu().numpy())
    (bg, og), (bc, oc) = got["cuda"], got["cpu"]
    assert (og != oc).sum() <= 0.05 * S and og.sum() > 0.9 * S
    both = og & oc
    assert (np.abs(bg - bc)[both] <= 1e-6 * np.maximum(1.0, np.abs(bc[both]))).all()
