"""The rest of Step 1 in the port against `python -m regenie_tpu`, both on
the CPU in this process, on a small synthetic BED with a polygenic effect
(N = 900, 3 traits, 2 chromosomes, --bsize 50): --prior-alpha, --test-l0,
--select-l0 FILE (an adaptive selection and --rm-l0-pct), --print (K-fold:
<out>_level1.betas; LOOCV: <out>_step1_betas.txt) and --debug (the model
inputs <out>_y.txt, _x.txt and, for binary traits, _offset.txt), on
quantitative and binary traits (binary traits take LOOCV below 5,000
samples). Every .loco, --print and --debug file is the JAX package's byte
for byte, but the .loco files of --select-l0 on K-fold level 1 with an
unpenalized column: there the reference's eigenvalue-aligned multiplier
(1 / (d + tau * mult) with mult = 0 on the smallest eigenvalues of the
leave-fold-out Gram) magnifies rounding, and its own betas move under a
1e-15 perturbation of their inputs by as much as the port's differ from
them. Such a run is held through a witness: the port's level-1 betas of
each trait within WITNESS_FACTOR x the JAX package's own spread under
WITNESS_DRAWS perturbations of W, and each .loco file that is not the
same bytes (same rows and NA pattern) within WITNESS_FACTOR x the largest
gap those perturbations give the JAX package's own .loco values
(ROADMAP.md §3)."""

import os

import numpy as np
import pytest

from chip_smoke import write_bt_table, write_dataset
from test_torch_interaction import run_jax, run_port

N = 900
WITNESS_DRAWS = 4
WITNESS_FACTOR = 10.0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_step1_options"))
    g = write_dataset(d, seed=9, N=N, P=3, n_inc=1, n_cov=3, n_remove=5,
                      chroms=((1, 150), (2, 100)), effect_sd=0.15)
    Y = np.genfromtxt(f"{d}/pheno.txt", skip_header=1, missing_values="NA")[:, 2:]
    write_bt_table(f"{d}/pheno_bt.txt", Y, seed=3, prev=(0.2, 0.4))
    # --select-l0's file: CHROM BLOCK and a -log10 p per trait for each of
    # the 5 blocks, two of them strong
    rng = np.random.default_rng(2)
    pv = rng.uniform(0.0, 1.0, size=(5, 3))
    pv[1] = [9.0, 7.5, 8.2]
    pv[3, 1] = 6.0
    for name, cols in (("l0_pv.txt", [0, 1, 2]), ("l0_pv2.txt", [1, 2])):
        with open(f"{d}/{name}", "w") as fh:
            for b in range(5):
                fh.write(f"{1 if b < 3 else 2} {b + 1} "
                         + " ".join(f"{x:.6f}" for x in pv[b, cols]) + "\n")
    return d, g


# id: (flags, trait table, extra files compared byte for byte)
SCENARIOS = {
    "prior_alpha_kfold": (["--prior-alpha", "0.5"], "pheno", []),
    "prior_alpha_loocv": (["--prior-alpha", "-0.3", "--loocv"], "pheno", []),
    "test_l0_kfold": (["--test-l0", "--l0-pval-thr", "1e-3"], "pheno", []),
    "test_l0_loocv": (["--test-l0", "--l0-pval-thr", "1e-3", "--loocv"], "pheno", []),
    "select_l0_kfold": (["--select-l0", "@PV"], "pheno", ["WITNESS"]),
    "select_l0_loocv": (["--select-l0", "@PV", "--loocv"], "pheno", []),
    "rm_l0_pct": (["--select-l0", "@PV", "--rm-l0-pct", "40"], "pheno", []),
    "print_kfold": (["--print", "--phenoColList", "Y2"], "pheno", ["_level1.betas"]),
    "print_loocv": (["--print", "--phenoColList", "Y2", "--loocv"], "pheno",
                    ["_step1_betas.txt"]),
    "debug_qt": (["--debug"], "pheno", ["_y.txt", "_x.txt"]),
    "bt_debug": (["--bt", "--debug"], "pheno_bt", ["_y.txt", "_x.txt", "_offset.txt"]),
    "bt_prior_alpha": (["--bt", "--prior-alpha", "0.5"], "pheno_bt", []),
    "bt_select_l0": (["--bt", "--select-l0", "@PV2", "--phenoColList", "Y2,Y3"],
                     "pheno_bt", []),
    "bt_test_l0": (["--bt", "--test-l0", "--l0-pval-thr", "1e-3"], "pheno_bt", []),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_step1_option_matches_jax(data, scenario, monkeypatch):
    d, g = data
    flags, table, files = SCENARIOS[scenario]
    flags = [f.replace("@PV2", f"{d}/l0_pv2.txt").replace("@PV", f"{d}/l0_pv.txt")
             for f in flags]
    argv = ["--step", "1", "--bed", g, "--phenoFile", f"{d}/{table}.txt", "--covarFile",
            f"{d}/covar.txt", "--remove", f"{d}/remove.txt", "--bsize", "50", *flags]
    jx, pt = f"{d}/jx_{scenario}", f"{d}/pt_{scenario}"
    witness = "WITNESS" in files
    files = [f for f in files if f != "WITNESS"]
    jrec, prec = _Rec(), []
    if witness:
        _record_level1(monkeypatch, jrec, prec)
    run_jax(argv + ["--out", jx], monkeypatch)
    log = run_port(argv + ["--out", pt], monkeypatch)
    locos = sorted(f for f in os.listdir(d) if f.startswith(f"pt_{scenario}_")
                   and f.endswith(".loco"))
    assert locos
    if witness:
        _witness_level1(jrec, prec)
        monkeypatch.undo()
        draws = _perturbed_jax_locos(argv, jx, monkeypatch)
    for f in locos:
        fj = f"{d}/{f.replace('pt_', 'jx_', 1)}"
        a, b = open(f"{d}/{f}", "rb").read(), open(fj, "rb").read()
        if witness and a != b:
            # the JAX package's own .loco values under the perturbations
            la, na, va = _loco_values(f"{d}/{f}")
            lb, nb, vb = _loco_values(fj)
            assert la == lb and na == nb, f
            spread = max(np.abs(v - vb).max() for v in draws[f[len(f"pt_{scenario}"):]])
            gap = np.abs(va - vb).max()
            print(f"{f}: gap {gap:.3e}, the JAX package's own spread {spread:.3e}")
            assert gap <= WITNESS_FACTOR * spread, (f, gap, spread)
        else:
            assert a == b, f
    for suf in files:
        a, b = open(pt + suf, "rb").read(), open(jx + suf, "rb").read()
        assert a == b and len(a) > 0, suf
    if "--test-l0" in flags:
        assert "top SNPs per trait" in log
    if "--select-l0" in flags:
        assert "checking level 0 predictors" in log
    if "--prior-alpha" in flags:
        assert "MAF dependent prior" in log
    if "--debug" in flags:
        assert "memory usage=" in log and "peak memory usage" in log


def _record_level1(monkeypatch, jrec, prec):
    """Record each package's K-fold level-1 calls: the JAX package's
    inputs and betas, the port's betas."""
    import jax.numpy as jnp
    from regenie_tpu.models import step1 as j1
    from regenie_tpu_torch.models import step1 as p1

    jorig, porig = j1.level1_linear_kfold, p1.level1_linear_kfold

    def jcall(W, Y, valid, taus, pgs_folds=None, ridge_mult=None):
        out = jorig(W, Y, valid, taus, pgs_folds=pgs_folds, ridge_mult=ridge_mult)
        args = [None if x is None else np.asarray(x) for x in (W, Y, valid, taus,
                                                               ridge_mult)]
        jrec.append((args, np.asarray(out[0])))
        return out

    def pcall(*a, **k):
        out = porig(*a, **k)
        prec.append(out[0].cpu().numpy())
        return out

    monkeypatch.setattr(j1, "level1_linear_kfold", jcall)
    monkeypatch.setattr(p1, "level1_linear_kfold", pcall)
    jrec.jorig, jrec.jnp = jorig, jnp


class _Rec(list):
    pass


def _witness_level1(jrec, prec):
    """The port's level-1 betas of each trait against the JAX package's:
    within 1e-12 of their largest, or within WITNESS_FACTOR x the JAX
    package's own spread under WITNESS_DRAWS perturbations of W at 1e-15."""
    assert len(jrec) == len(prec) > 0
    rng = np.random.default_rng(5)
    for (args, bj), bp in zip(jrec, prec):
        W, Y, valid, taus, mult = args
        scale = np.abs(bj).max()
        gap = np.abs(bp - bj).max()
        if gap <= 1e-12 * scale:
            continue
        spread = 0.0
        for _ in range(WITNESS_DRAWS):
            Wp = W * (1 + 1e-15 * rng.standard_normal(W.shape))
            jnp = jrec.jnp
            b2 = np.asarray(jrec.jorig(jnp.asarray(Wp), jnp.asarray(Y), jnp.asarray(valid),
                                       jnp.asarray(taus),
                                       ridge_mult=None if mult is None else jnp.asarray(mult))[0])
            spread = max(spread, np.abs(b2 - bj).max())
        print(f"level-1 betas: port gap {gap / scale:.3e}, the JAX package's own spread "
              f"{spread / scale:.3e} (of the largest)")
        assert gap <= WITNESS_FACTOR * spread, (gap, spread)


def _loco_values(path):
    """(row labels, NA pattern, values) of a .loco file."""
    rows = [r.split() for r in open(path).read().splitlines()[1:]]
    return ([r[0] for r in rows], [[x == "NA" for x in r] for r in rows],
            np.array([float(x) for r in rows for x in r[1:] if x != "NA"]))


def _perturbed_jax_locos(argv, out, monkeypatch):
    """The JAX package's .loco values of the run with the inputs of its
    K-fold level 1 scaled entry by entry by 1 + 1e-15 z, one run a draw:
    {file suffix: [values of each draw]}."""
    from regenie_tpu.models import step1 as j1

    orig = j1.level1_linear_kfold
    rng = np.random.default_rng(5)

    def perturbed(W, *a, **k):
        Wn = np.asarray(W)
        return orig(Wn * (1 + 1e-15 * rng.standard_normal(Wn.shape)), *a, **k)

    monkeypatch.setattr(j1, "level1_linear_kfold", perturbed)
    draws = {}
    for i in range(WITNESS_DRAWS):
        run_jax(argv + ["--out", f"{out}_w{i}"], monkeypatch)
        d, base = os.path.split(out)
        for f in os.listdir(d):
            if f.startswith(f"{base}_w{i}_") and f.endswith(".loco"):
                draws.setdefault(f[len(base) + len(f"_w{i}"):], []).append(
                    _loco_values(f"{d}/{f}")[2])
    monkeypatch.setattr(j1, "level1_linear_kfold", orig)
    return draws
