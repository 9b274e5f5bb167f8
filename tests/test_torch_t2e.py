"""Slice tests of Step 2 on time-to-event traits (--t2e, Cox) in the
PyTorch port, on the CPU against the JAX package:

- models/survival.py (the port's numpy copy) bit for bit against
  regenie_tpu/models/survival.py, the empty design included;
- the Cox null state of a chromosome (models/step2_t2e.prep_chromosome);
- ops/fused_score.make_t2e_block_fn on plain products against the JAX
  package's make_t2e_block_fn with use_pallas=False, within 1e-9;
- the CLI on small synthetic BED, PGEN (hardcalls and dosages), BGEN and
  chrX BED files with write_t2e_table's endpoints (times tied at 0.01,
  NA times, --remove): the fused route byte for byte against
  REGENIE_TPU_FUSED=1 python -m regenie_tpu (--firth --approx at
  --pThresh 0.9, --coxnofirth, --htp XT --htp-with-event), the dense
  route within rel 1e-9 against REGENIE_TPU_FUSED=0 (BGEN, PGEN dosages,
  --coxscore-exact).

One test needs an NVIDIA GPU (marker `cuda`): the T2E CLI on the card
(fused_i8 once per block, no other kernel) against the CPU. On the GPU
machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_t2e.py
"""

import os
import re

import numpy as np
import pytest

from chip_smoke import (_variant_blocks, chrx_positions, t2e_flags,
                        write_bgen_dataset, write_dataset, write_pgen_dataset,
                        write_t2e_table)

N = 900
NT = 2  # endpoints: T1, T2 with events E1, E2


def _t2e_table(d):
    """d/pheno_t2e.txt: NT endpoints from d/pheno.txt's first traits (their
    genetic effects included), T1 with 5% NA times."""
    Y = np.genfromtxt(f"{d}/pheno.txt", skip_header=1, missing_values="NA")[:, 2:]
    X = np.genfromtxt(f"{d}/covar.txt", skip_header=1)[:, 2:]
    write_t2e_table(f"{d}/pheno_t2e.txt", np.nan_to_num(Y[:, :NT]), seed=3,
                    n_na=1, X=X)


def _src(name, d, g):
    if name == "bgen":
        return ["--bgen", g, "--sample", f"{d}/geno.sample"]
    return ["--pgen" if name.startswith("pgen") else "--bed", g]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_t2e"))
    kw = dict(seed=4, N=N, P=3, n_inc=1, n_cov=3, n_remove=5, effect_sd=0.5)
    two = dict(chroms=((1, 150), (2, 90)))
    chrx = dict(chroms=((1, 100), ("X", 120)),
                positions={"X": chrx_positions(120, 20, 20)})
    out = {}
    for name, fn, extra in (("bed", write_dataset, two),
                            ("bgen", write_bgen_dataset, two),
                            ("pgen", write_pgen_dataset, two),
                            ("pgen_dosage", write_pgen_dataset,
                             {**two, "dosage": 0.5}),
                            ("chrx", write_dataset, chrx)):
        d = os.path.join(root, name)
        os.makedirs(d)
        g = fn(d, **kw, **extra)
        _t2e_table(d)
        out[name] = (d, _src(name, d, g))
    return out


def _base(d, src):
    return [*src, "--phenoFile", f"{d}/pheno_t2e.txt", "--covarFile",
            f"{d}/covar.txt", "--remove", f"{d}/remove.txt", *t2e_flags(NT)]


def _jax(argv, monkeypatch, fused=True):
    from regenie_tpu import cli as jcli

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("REGENIE_TPU_FUSED", "1" if fused else "0")
    jcli.main(argv)


def _port(argv, monkeypatch, fused=True, device="cpu"):
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, device)
    if fused:
        monkeypatch.delenv("REGENIE_TPU_FUSED", raising=False)
    else:
        monkeypatch.setenv("REGENIE_TPU_FUSED", "0")
    cli.main(argv)
    return open(argv[-1] + ".log").read()


def _assert_rows_close(f, g, rtol=1e-9):
    """Same header, row count and NA pattern; numeric fields within rtol."""
    la = open(f).read().splitlines()
    lb = open(g).read().splitlines()
    assert len(la) == len(lb) > 1 and la[0] == lb[0], (f, len(la), len(lb))
    for ra, rb in zip(la[1:], lb[1:]):
        ta = ra.replace(";", " ").replace("=", " ").split()
        tb = rb.replace(";", " ").replace("=", " ").split()
        assert len(ta) == len(tb), (ra, rb)
        for xa, xb in zip(ta, tb):
            if xa != xb:
                fa, fb = float(xa), float(xb)  # raises on an NA mismatch
                assert abs(fa - fb) <= rtol * max(1.0, abs(fa)), (ra, rb)


FIRTH = ["--firth", "--approx", "--pThresh", "0.9"]
# name: (dataset, flags, fused route)
SCENARIOS = {
    "bed_firth": ("bed", FIRTH, True),
    "bed_htp_event": ("bed", [*FIRTH, "--htp", "XT", "--htp-with-event"], True),
    "pgen_coxnofirth": ("pgen", [*FIRTH, "--coxnofirth"], True),
    "chrx_bed_firth": ("chrx", FIRTH, True),
    "chrx_bed_htp": ("chrx", ["--htp", "XT"], True),
    "bgen_firth": ("bgen", FIRTH, False),
    "pgen_dosage": ("pgen_dosage", ["--htp", "XT"], False),
    "bed_coxscore_exact": ("bed", ["--coxscore-exact"], False),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """The port's Step 2 --t2e on the CPU against the JAX package's: the
    fused route (BED and PGEN hardcalls, chrX with the male tail) byte for
    byte against REGENIE_TPU_FUSED=1; the dense route (BGEN, PGEN dosages,
    --coxscore-exact, which the port routes there by itself) within rel
    1e-9 against REGENIE_TPU_FUSED=0. A fused run takes no block to the
    dense route, and chrX's non-PAR blocks take the male tail."""
    name, flags, fused = SCENARIOS[scenario]
    d, src = data[name]
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    argv = ["--step", "2", *_base(d, src), "--bsize", "64", "--ignore-pred", *flags]
    _jax(argv + ["--out", jx], monkeypatch, fused)
    log = _port(argv + ["--out", pt], monkeypatch)
    assert ("fused packed-bytes scorer on cpu" if fused
            else "dense scorer on cpu") in log
    if not fused:
        assert re.search(r" \* dense route: (\d+) of \1 blocks", log), log
    else:
        # every block fused, chrX's non-PAR ones with the male tail
        nblk, nx = _variant_blocks(src, bsize=64)
        assert f" * dense route: 0 of {nblk} blocks\n" in log, log
        if nx:
            assert f"on the fused route (male tail): {nx}\n" in log, log
    for p in range(1, NT + 1):
        f, g = f"{pt}_T{p}.regenie", f"{jx}_T{p}.regenie"
        if fused:
            assert open(f, "rb").read() == open(g, "rb").read(), f
        else:
            _assert_rows_close(g, f)
        assert not os.path.exists(f"{pt}_E{p}.regenie")
    rows = open(f"{pt}_T1.regenie").read().splitlines()
    if "--htp" in flags:
        model = "ADD-COX-FIRTH" if "--firth" in flags else "ADD-COX"
        assert f"\t{model}\t" in rows[1]
        trait = "E1" if "--htp-with-event" in flags else "T1"
        assert rows[1].split("\t")[5] == trait
    if "--firth" in flags:
        assert "Number of tests with Firth correction" in log


def _surv_inputs(seed, n=700, p=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    eta = X @ np.array([0.3, -0.2, 0.1])[:p]
    t = np.round(rng.exponential(1.0, n) / np.exp(eta) * 10, 1)
    c = rng.uniform(0, 15, n)
    status = (t <= c).astype(float)
    time = np.minimum(t, c)
    mask = rng.random(n) > 0.05
    offset = np.where(mask, rng.normal(scale=0.2, size=n), 0.0)
    X = X * mask[:, None]
    return time, status, mask, X, offset


@pytest.mark.parametrize("p", [3, 0])
def test_survival_bit_for_bit(p):
    """SurvivalData, _loglik, CoxRidge, CoxMLE (fit and test_prep) and
    CoxFirth (fit, fit_1; with and without the penalty) of the port equal
    the JAX package's bit for bit, on tied times with masked samples; p=0
    is the empty design of a Cox run without covariates."""
    from regenie_tpu.models import survival as J
    from regenie_tpu_torch.models import survival as T

    time, status, mask, X, offset = _surv_inputs(7, p=max(p, 1))
    X = X[:, :p]
    outs = []
    for m in (J, T):
        o = {}
        for nw in (False, True):
            sd = m.SurvivalData()
            sd.setup(time, status, mask, norm_weights=nw)
            for f in ("order", "w", "dd", "ww", "ww_k", "rskcount", "group"):
                o[f"sd{nw}.{f}"] = getattr(sd, f)
        o["loglik"] = m._loglik(sd, sd.to_order(np.where(mask, offset, 0.0)))
        sd = m.SurvivalData()
        sd.setup(time, status, mask)
        cr = m.CoxRidge(sd, X, offset, mask, 0.0, 100, 30, 2.5e-4)
        cr.fit()
        o["ridge"] = (cr.beta, cr.eta, cr.converge)
        mle = m.CoxMLE(100, 30, 2.5e-4)
        mle.fit(sd, X, offset, mask, cr.beta, cr.eta)
        mle.test_prep(sd, X, offset, mask)
        o["mle"] = (mle.beta, mle.residual, mle.WX1, mle.X1_X1WX1inv,
                    mle.res_var, mle.cov_inv, mle.Dhalf)
        for use in (True, False):
            fx = m.CoxFirth(sd, X, offset, p, 100, 30, 2.5e-4, 2.5e-4, 1e-8, 25.0,
                            use, beta_init=mle.beta)
            fx.fit()
            o[f"firth{use}"] = (fx.beta, fx.eta, fx.converge, fx.loglike)
            g = mle.residual * 3.0 + 0.1
            f1 = m.CoxFirth(sd, g[:, None], fx.eta, 1, 100, 30, 2.5e-4, 2.5e-4,
                            1e-8, 25.0, use)
            f1.fit_1(g)
            o[f"fit1{use}"] = (f1.beta1, f1.second_der_1, f1.loglike, f1.converge)
        lam = cr._deviance(sd.to_order(cr.eta))
        o["ridge_lam"] = lam
        outs.append(o)
    for k in outs[0]:
        a, b = outs[0][k], outs[1][k]
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)


def test_null_state_matches_jax(data, monkeypatch):
    """step2_t2e.prep_chromosome against the JAX package's on the BED's
    first chromosome, with --firth --approx: residuals, the null Firth
    offsets and every trait's score-test pieces, bit for bit."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.prep import prepare as jprepare
    from regenie_tpu.run_step2 import Step2Engine as JEngine
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.run_step2 import open_engine

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    d, src = data["bed"]
    argv = ["--step", "2", *_base(d, src), "--ignore-pred", *FIRTH,
            "--out", f"{d}/eng"]
    eng, _ = open_engine(cli.args_to_params(cli.build_parser().parse_args(argv)),
                         log=lambda *a: None, device="cpu")
    jp = jcli.args_to_params(jcli.build_parser().parse_args(argv))
    jp.test_mode = True
    rd = jprepare(jp, log=lambda *a: None)
    jeng = JEngine(jp, rd.geno, rd.pheno, None, lambda *a: None)
    np.testing.assert_array_equal(eng.pd.new_cov, rd.pheno.new_cov)
    np.testing.assert_array_equal(eng.pd.masked_indivs, rd.pheno.masked_indivs)
    eng.prep_chrom(1)
    jeng.prep_chrom(1)
    st, js = eng.null_state, jeng.bt_state
    assert st.time_cols == js.time_cols == [0, 1]
    np.testing.assert_array_equal(st.res, js.res)
    np.testing.assert_array_equal(st.firth_offset, js.firth_offset)
    for ph in st.time_cols:
        for f in ("WX1", "X1_X1WX1inv", "residual", "res_var", "w_exp_eta",
                  "Dhalf", "UhalfX", "cov_inv", "mu"):
            np.testing.assert_array_equal(getattr(st.mle[ph], f),
                                          getattr(js.mle[ph], f), err_msg=f)
    assert list(eng.pd.pheno_pass) == [True, True, False, False]
    assert eng.model_type() == "ADD-COX-FIRTH"
    eng.gd.close()


def test_block_fn_matches_jax():
    """make_t2e_block_fn on the plain float64 products against the JAX
    package's make_t2e_block_fn(use_pallas=False) on the same operand and
    null constants, by default (ADD, the flip), with --ref-first and for
    DOM/REC: every output within 1e-9 of its scale."""
    import jax.numpy as jnp
    import torch

    from regenie_tpu.ops import fused_score as jf
    from regenie_tpu_torch.ops import fused_score as pf

    rng = np.random.default_rng(5)
    n, Tt, q, P, B = 403, 2, 4, 3, 37
    ind = rng.random(n) > 0.03
    maskf = (rng.random((n, P)) > 0.05) & ind[:, None]
    cols = []
    for _ in range(Tt):
        cols += [rng.random((n, q)) * ind[:, None], rng.normal(size=(n, q)) * ind[:, None],
                 rng.normal(size=(n, 1)) * maskf[:, :1]]
    case = (rng.random((n, P)) < 0.2) & maskf
    Wext = np.concatenate(cols + [case, maskf, ind[:, None]], axis=1).astype(np.float64)
    Rtv = rng.normal(size=(Tt, q))
    Rm = rng.normal(size=(Tt, q, q))
    RtR = np.einsum("tkl,tml->tkm", Rm, Rm)
    rv = rng.random(Tt) + 0.5
    icol = Tt * (2 * q + 1) + 2 * P
    C_used = icol + 1
    nb = (n + 3) // 4
    raw = rng.integers(0, 256, size=(B, nb), dtype=np.uint8)
    Wp_j, usum_j = jf.plane_pack(Wext, nb, split=False, dtype=np.float64)
    Wp_t, usum_t = pf.plane_pack(Wext, nb, False)
    np.testing.assert_array_equal(usum_j, usum_t)
    raw_p = jf.pad_raw(raw, Wp_j.shape[1])
    for test_type, ref_first in ((0, False), (0, True), (1, False), (2, False)):
        args = (Rtv, RtR, rv, C_used, icol, float(ind.sum()), Tt, q)
        jout = jf.make_t2e_block_fn(Wp_j, usum_j, *args, False, test_type,
                                    ref_first)(jnp.asarray(raw_p))
        pout = pf.make_t2e_block_fn(Wp_t, usum_t, *args, False, test_type,
                                    ref_first)(torch.from_numpy(raw_p))
        for name, a, b in zip(("S1", "SQ", "SM", "flip", "Tnum", "denum"),
                              jout, pout):
            a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
            scale = max(1.0, np.abs(a).max())
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-9 * scale,
                                       err_msg=f"{name} {test_type} {ref_first}")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [FIRTH, ["--htp", "XT", "--htp-with-event"]])
def test_cli_on_card_matches_cpu(cuda, tmp_path, flags, monkeypatch):
    """The T2E CLI on the card: fused_i8 once per block and no other
    kernel, every field within the repository's cross-backend bars of the
    CPU run's."""
    from chip_smoke import _compare_files
    from regenie_tpu_torch.ops import kernels

    d = str(tmp_path)
    g = write_dataset(d, seed=4, N=N, P=3, n_inc=1, n_cov=3, n_remove=5,
                      effect_sd=0.5, chroms=((1, 150), (2, 90)))
    _t2e_table(d)
    argv = ["--step", "2", *_base(d, ["--bed", g]), "--bsize", "64",
            "--ignore-pred", *flags]
    for w in kernels.WRAPPERS.values():
        w.launches = 0
    _port(argv + ["--out", f"{d}/gpu"], monkeypatch, device="cuda")
    counts = {k: w.launches for k, w in kernels.WRAPPERS.items()}
    # 5 blocks of at most 64: 150 variants on chromosome 1, 90 on 2
    assert counts["fused_i8"] == 5 and sum(counts.values()) == 5, counts
    _port(argv + ["--out", f"{d}/cpu"], monkeypatch)
    for p in range(1, NT + 1):
        _compare_files(f"{d}/gpu_T{p}.regenie", f"{d}/cpu_T{p}.regenie")
