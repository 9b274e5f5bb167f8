"""The port's phenotype and covariate readers (regenie_tpu_torch.io.pheno,
which parse a whole table at once) against the JAX package's line-by-line
readers, on the CPU: the same values, masks and sample flags, and the
same errors, on tables with missing-value strings, strict mode, binary
traits in 0/1 and 1/2 coding, categorical covariates with missing levels,
samples absent from the genotype file, tabs, CRLF line ends, and
whitespace the whole-text split does not share with the line reader."""

import numpy as np
import pytest

from regenie_tpu.io import pheno as jpheno
from regenie_tpu_torch.config import Params
from regenie_tpu_torch.io import pheno as tpheno

N = 30


def _params(**kw):
    p = Params()
    p.n_samples = N
    p.test_mode = True
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _table(rng, cols, bt=False, cc12=False, sep=" ", eol="\n"):
    rows = []
    for i in range(N + 3):  # three samples the genotype file lacks
        vals = []
        for _ in range(cols):
            r = rng.random()
            if r < 0.08:
                vals.append(["NA", "nan", "-inf"][rng.integers(3)])
            elif bt:
                vals.append(str(int(rng.random() < 0.3) + (1 if cc12 else 0)))
            else:
                vals.append(f"{rng.normal():.6f}")
        rows.append(sep.join([f"F{i}", f"I{i}", *vals]))
    rng.shuffle(rows)
    head = sep.join(["FID", "IID", *[f"Y{j + 1}" for j in range(cols)]])
    return eol.join([head, *rows]) + eol


CASES = {
    "qt": dict(),
    "qt_strict": dict(params=dict(strict_mode=True)),
    "qt_tabs_crlf": dict(sep="\t", eol="\r\n"),
    "qt_vtab": dict(sep=" \t "),
    "bt": dict(bt=True, params=dict(trait_mode=1)),
    "bt_cc12_strict": dict(bt=True, cc12=True,
                           params=dict(trait_mode=1, cc12=True, strict_mode=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_pheno_matches_jax(tmp_path, case):
    c = CASES[case]
    rng = np.random.default_rng(len(case))
    text = _table(rng, 4, c.get("bt", False), c.get("cc12", False),
                  c.get("sep", " "), c.get("eol", "\n"))
    if case == "qt_vtab":
        # a token ending in a vertical tab: one field for the line reader
        # (float() strips it), two for a whole-text split
        head, first, rest = text.split("\n", 2)
        t = first.split()
        text = "\n".join([head, " ".join(t[:2] + [t[2] + "\x0b"] + t[3:]), rest])
    path = tmp_path / "p.txt"
    path.write_bytes(text.encode())
    index = {f"F{i}_I{i}": i for i in range(N)}
    kw = dict(pheno_file=str(path), min_case_count=1, **c.get("params", {}))
    got = tpheno.read_pheno(_params(**kw), index)
    want = jpheno.read_pheno(_params(**kw), index)
    for f in ("phenotypes", "masked_indivs", "ind_in_analysis", "pheno_pass",
              "phenotypes_raw"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.pheno_names == want.pheno_names


@pytest.mark.parametrize("bad", ["dup", "short", "word", "bt_value"])
def test_read_pheno_errors_match_jax(tmp_path, bad):
    rng = np.random.default_rng(7)
    bt = bad == "bt_value"
    lines = _table(rng, 3, bt=bt).splitlines()
    # a row of a sample in the genotype file
    r = next(k for k in range(1, len(lines)) if int(lines[k].split()[1][1:]) < N)
    t = lines[r].split()
    if bad == "dup":
        lines.append(lines[r])
    elif bad == "short":
        lines[r] = " ".join(t[:-1])
    else:
        lines[r] = " ".join(t[:3] + ["x1" if bad == "word" else "2"] + t[4:])
    path = tmp_path / "p.txt"
    path.write_text("\n".join(lines) + "\n")
    index = {f"F{i}_I{i}": i for i in range(N)}
    kw = dict(pheno_file=str(path), min_case_count=1,
              trait_mode=1 if bt else 0)
    with pytest.raises(ValueError) as want:
        jpheno.read_pheno(_params(**kw), index)
    with pytest.raises(ValueError) as got:
        tpheno.read_pheno(_params(**kw), index)
    assert str(got.value) == str(want.value)


def test_read_covariates_matches_jax(tmp_path):
    """Quantitative and categorical covariates (levels coded in order of
    first appearance, a sample's first missing covariate ending its row)."""
    rng = np.random.default_rng(3)
    lines = ["FID IID C1 S C2 Y1"]
    for i in range(N + 2):
        c1 = "NA" if rng.random() < 0.1 else f"{rng.normal():.5f}"
        cat = "NA" if rng.random() < 0.1 else ["b", "a", "c"][rng.integers(3)]
        c2 = f"{rng.normal():.5f}"
        lines.append(f"F{i} I{i} {c1} {cat} {c2} 0.5")
    path = tmp_path / "c.txt"
    path.write_text("\n".join(lines) + "\n")
    index = {f"F{i}_I{i}": i for i in range(N)}
    kw = dict(cov_file=str(path), cat_cov_cols=["S"])
    got = tpheno.read_covariates(_params(**kw), index, ["Y1"])
    want = jpheno.read_covariates(_params(**kw), index, ["Y1"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == jpheno.read_covariates.cov_names
