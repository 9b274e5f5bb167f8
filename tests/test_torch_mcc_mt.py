"""The MCC test (--mcc) and the multi-trait tests (--mt) in the port
against the JAX package, both on the CPU in this process:

- models/mcc.py: dkat_pvals and apply_mcc_qt (everywhere, and behind
  --mcc-thr on the skewed traits only; the block as a host array and as
  a tensor, whose needed rows alone come back);
- models/multitrait.py: setup_mt and run_mt_block (the block's products
  in torch, the tests' algebra and tails on the host) on traits with a
  skewed principal component, so that the ACPC tests' DKAT runs;
- the CLI against `python -m regenie_tpu` on a synthetic BED (N = 600, 3
  traits, two of them skewed in a second table): --mcc on every row and
  behind --mcc-thr with --mcc-skew, --mt --strict --no-split (with
  --gz). Every array within rel 1e-9; the files byte for byte, or each
  number within rel 1e-9.
"""

import gzip

import numpy as np
import pytest
import torch

from chip_smoke import write_dataset
from test_torch_interaction import run_jax, run_port

N = 600
CHROMS = ((1, 150), (2, 70))


def _close(a, b, rtol=1e-9, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert (np.isnan(a) == np.isnan(b)).all(), what
    ok = ~np.isnan(a)
    if ok.any():
        scale = np.maximum(1.0, np.abs(a[ok]))
        assert (np.abs(a[ok] - b[ok]) <= rtol * scale).all(), (what, a, b)


def _skewed(rng, n, q):
    """Residual-like traits, the first two skewed (exponential, chi-square),
    normalized as the engine's res."""
    Y = np.column_stack([rng.exponential(size=n), rng.chisquare(2, size=n)]
                        + [rng.normal(size=n) for _ in range(q - 2)])
    Y -= Y.mean(axis=0)
    return Y / (np.linalg.norm(Y, axis=0) / np.sqrt(n - 1))


def test_dkat_pvals_matches_jax():
    """DKAT p-values and skips of a block against each trait, a masked
    sample set and a monomorphic row included."""
    from regenie_tpu.models import mcc as J
    from regenie_tpu_torch.models import mcc as T

    rng = np.random.default_rng(0)
    n, B, P = 300, 12, 3
    y = _skewed(rng, n, P)
    mask = rng.random((n, P)) > 0.1
    G = rng.normal(size=(B, n))
    G[3] = 0.0
    G[5] += 0.3 * y[:, 0]
    neff = mask.sum(axis=0).astype(np.float64)
    a, b = J.dkat_pvals(G, y, mask, neff, 4), T.dkat_pvals(G, y, mask, neff, 4)
    _close(a[0], b[0])
    assert (a[1] == b[1]).all() and a[1][3].all()


@pytest.mark.parametrize("thr,skewed_only", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_apply_mcc_qt_matches_jax(thr, skewed_only, as_tensor):
    """apply_mcc_qt rewrites LOG10P and SE of the rows that need MCC (all,
    or past --mcc-thr; every trait or the skewed ones) exactly as the JAX
    package does; a tensor block gives the host array's results."""
    from types import SimpleNamespace

    from regenie_tpu.models import mcc as J
    from regenie_tpu_torch.models import mcc as T
    from regenie_tpu_torch.utils.stats import chisq_neglog10

    rng = np.random.default_rng(1)
    n, B, P = 400, 20, 3
    y = _skewed(rng, n, P)
    mask = rng.random((n, P)) > 0.05
    G = rng.normal(size=(B, n))
    G[:6] += 0.25 * y[:, :1].T
    stats = (G * mask.T[0]) @ y / np.sqrt(n)
    chisq = stats**2
    se = np.abs(rng.normal(size=(B, P))) + 0.1
    pd = SimpleNamespace(masked_indivs=mask, Neff=mask.sum(axis=0).astype(np.float64),
                         mcc_Y=np.array([True, not skewed_only, False]))
    params = SimpleNamespace(mcc_apply_thr=thr, mcc_thr_nlog10=2.0, ncov_analyzed=3)
    out = []
    for mod in (J, T):
        logp, s, c = chisq_neglog10(chisq), se.copy(), chisq.copy()
        src = torch.from_numpy(G) if (mod is T and as_tensor) else G
        fail = mod.apply_mcc_qt(params, pd, src, y, logp, s, c)
        out.append((logp, s, c, fail))
    for x, z in zip(*out):
        _close(x, z)
    assert (out[0][0] != chisq_neglog10(chisq)).any()


def test_run_mt_block_matches_jax():
    """setup_mt and the 14 tests, the minP/minQ and the four z-score
    matrices of a block against the JAX package's, with skewed principal
    components (the ACPC tests' DKAT path) and a block given as a tensor."""
    from regenie_tpu.models import multitrait as J
    from regenie_tpu_torch.models import multitrait as T

    rng = np.random.default_rng(7)
    n, q, B = 500, 3, 16
    res = _skewed(rng, n, q)
    mask = np.ones((n, q), dtype=bool)
    mask[rng.random(n) < 0.05, 1] = False
    G = rng.normal(size=(B, n))
    G[:5] += 0.5 * res[:, :1].T
    G -= G.mean(axis=1, keepdims=True)
    G /= np.linalg.norm(G, axis=1, keepdims=True) / np.sqrt(n - 1)
    sa, sb = J.setup_mt(res, mask), T.setup_mt(res, mask)
    for f in ("YtY", "Syy_inv", "lambdas", "PC_Y0", "RPC_Y0", "skew_pc", "nnls_wts"):
        _close(getattr(sa, f), getattr(sb, f), rtol=1e-12, what=f)
    assert sb.n_skewed_pc > 0
    ra = J.run_mt_block(sa, G, None)
    for src in (G, torch.from_numpy(G)):
        rb = T.run_mt_block(sb, src, None)
        assert sorted(ra) == sorted(rb)
        for k in ra:
            _close(ra[k], rb[k], what=k)


# ---- the CLI ----

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The BED, its tables, and pheno_skew.txt: Y1 exponentiated, Y2
    cubed (both skewed), Y3 as it is."""
    d = str(tmp_path_factory.mktemp("torch_mcc_mt"))
    g = write_dataset(d, seed=31, N=N, chroms=CHROMS, P=3, n_inc=1, n_cov=3,
                      na_rate=0.1, n_remove=5, effect_sd=1.0)
    lines = open(f"{d}/pheno.txt").read().splitlines()
    with open(f"{d}/pheno_skew.txt", "w") as fh:
        fh.write(lines[0] + "\n")
        for ln in lines[1:]:
            t = ln.split()
            if t[2] != "NA":
                t[2] = f"{np.exp(float(t[2]) / 2):.6f}"
            if t[3] != "NA":
                t[3] = f"{float(t[3]) ** 3:.6f}"
            fh.write(" ".join(t) + "\n")
    return d, g


def _read(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        return fh.read()


def files_close(f, g, rtol=1e-9):
    """Two output files: byte for byte, or the same header, rows and NA
    pattern with every number within rel rtol. Returns whether equal."""
    a, b = _read(f), _read(g)
    if a == b:
        return True
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb) and la[0] == lb[0], (f, len(la), len(lb))
    for ra, rb in zip(la[1:], lb[1:]):
        ta, tb = ra.split(), rb.split()
        assert len(ta) == len(tb), (ra, rb)
        for xa, xb in zip(ta, tb):
            if xa != xb:
                fa, fb = float(xa), float(xb)  # raises on a text or NA mismatch
                assert abs(fa - fb) <= rtol * max(1.0, abs(fa)), (ra, rb)
    return False


SCENARIOS = {
    "mcc_all": ("pheno.txt", ["--mcc", "--mcc-thr", "1"], "_Y{}.regenie"),
    "mcc_skew_thr": ("pheno_skew.txt", ["--mcc", "--mcc-skew", "0.5", "--strict"],
                     "_Y{}.regenie"),
    "mt": ("pheno.txt", ["--mt", "--strict", "--no-split"], ".regenie"),
    "mt_skew_gz": ("pheno_skew.txt", ["--mt", "--strict", "--no-split", "--gz"],
                   ".regenie.gz"),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """The port's --mcc and --mt CLI against the JAX package's on the same
    files: the same files, byte for byte or within rel 1e-9 per number;
    MCC rewrites rows (it differs from the plain score test) and the
    multi-trait file has a row per variant past the filters."""
    d, g = data
    table, flags, suffix = SCENARIOS[scenario]
    base = ["--step", "2", "--bed", g, "--phenoFile", f"{d}/{table}",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--ignore-pred", "--bsize", "100"]
    argv = base + flags
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    run_jax(argv + ["--out", jx], monkeypatch)
    log = run_port(argv + ["--out", pt], monkeypatch)
    outs = [suffix.format(p) for p in (1, 2, 3)] if "{}" in suffix else [suffix]
    same = [files_close(jx + o, pt + o) for o in outs]
    rows = len(_read(pt + outs[0]).splitlines()) - 1
    assert rows > 150
    if scenario.startswith("mcc"):
        assert "dense scorer on cpu" in log
        plain = f"{d}/pt_{scenario}_plain"
        run_port(base + [f for f in flags if f == "--strict"] + ["--out", plain],
                 monkeypatch)
        assert any(_read(pt + o) != _read(plain + o) for o in outs)
    else:
        assert "multi-trait tests" in log
    print(f"{scenario}: {rows} rows, byte-identical per file = {same}")
