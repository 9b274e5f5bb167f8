"""The modes that the port refused until multi-trait tests, MultiPhen,
the MCC test, LD mode and --af-cc off binary traits were ported: each
former case of tests/test_torch_step2.py::test_unported_mode_raises now
runs, in the port and in `python -m regenie_tpu`, both on the CPU in this
process, on the same tiny data (N = 40, 8 variants; a BED, a BGEN, a BED
of chrX non-PAR variants), and the port's outcome is the JAX package's:
the same exception class, or the same output files (each number within
rel 1e-9; Step 1's _pred.list up to the output prefix).
"""

import glob
import gzip
import os

import pytest

from chip_smoke import chrx_positions, write_bgen_dataset, write_dataset

CASES = [
    ["--step", "1", "--t2e", "--phenoColList", "Y1", "--eventColList", "Y2",
     "--mcc"],
    ["bgen", "--t2e", "--phenoColList", "Y1", "--eventColList", "Y2", "--af-cc"],
    ["--t2e", "--phenoColList", "Y1", "--eventColList", "Y2", "--af-cc"],
    ["bgen", "--step", "1", "--multiphen", "--strict"],
    ["--mt", "--strict", "--no-split"], ["--mcc"],
    ["--set-list", "s.txt", "--anno-file", "a.txt", "--mask-def", "m.txt",
     "--mt", "--strict", "--no-split"],
    ["bgen", "--step", "1", "--compute-corr"], ["--compute-corr"],
    ["--step", "1", "--mcc"], ["bgen", "--step", "1", "--mcc"],
    ["chrx", "--multiphen", "--strict"], ["bgen", "--interaction", "C1", "--mcc"],
    ["bgen", "--step", "1", "--debug", "--af-cc"],
    ["bgen", "--mcc"], ["bgen", "--compute-corr"], ["--ct", "--af-cc"],
    ["bgen", "--multiphen", "--strict"],
    ["bgen", "--step", "1", "--test-l0", "--mt", "--strict", "--no-split"],
    ["--step", "1", "--test-l0", "--mt", "--strict", "--no-split"],
    ["--step", "1", "--select-l0", "f", "--compute-corr"],
    ["--step", "1", "--print", "--multiphen", "--strict"],
    ["--step", "1", "--prior-alpha", "0.5", "--af-cc"],
]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The three tiny data sets, written once for every case."""
    root = str(tmp_path_factory.mktemp("formerly_unported"))
    out = {}
    for name in ("bed", "bgen", "chrx"):
        d = os.path.join(root, name)
        os.makedirs(d)
        if name == "bgen":
            g = write_bgen_dataset(d, seed=0, N=40, chroms=((1, 8),), P=3, n_inc=1,
                                   n_cov=3)
            src = ["--bgen", g, "--sample", f"{d}/geno.sample"]
        elif name == "chrx":
            src = ["--bed", write_dataset(d, seed=0, N=40, chroms=(("X", 8),), P=3,
                                          n_inc=1, n_cov=3,
                                          positions={"X": chrx_positions(8, 2)})]
        else:
            src = ["--bed", write_dataset(d, seed=0, N=40, chroms=((1, 8),), P=3,
                                          n_inc=1, n_cov=3)]
        out[name] = (d, src)
    return out


def _outcome(run, argv, prefix):
    """(exception class name or None, {file suffix: text}) of a run."""
    try:
        run(argv + ["--out", prefix])
        err = None
    except (Exception, SystemExit) as e:  # noqa: BLE001 — the class is the outcome
        err = type(e).__name__
    files = {}
    for f in sorted(glob.glob(prefix + "*")):
        if f.endswith(".log"):
            continue
        op = gzip.open if f.endswith(".gz") else open
        with op(f, "rb") as fh:
            files[f[len(prefix):]] = fh.read()
    return err, files


def _same(a: bytes, b: bytes, pa: str, pb: str):
    """Byte for byte, or (text) each token equal once the output prefixes
    are swapped, numbers within rel 1e-9."""
    if a == b:
        return True
    try:
        ta, tb = a.decode().replace(pa, pb).split(), b.decode().split()
    except UnicodeDecodeError:
        return False
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x != y:
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                return False
            if not abs(fx - fy) <= 1e-9 * max(1.0, abs(fx)):
                return False
    return True


@pytest.mark.parametrize("flags", CASES)
def test_formerly_unported_mode_matches_jax(datasets, flags, tmp_path, monkeypatch):
    """The port runs each formerly refused case as the JAX package does:
    the same exception class, or the same files. Flags after "bgen" run on
    the BGEN, after "chrx" on the chrX BED; flags without --step run
    Step 2."""
    from regenie_tpu import cli as jcli
    from regenie_tpu_torch import cli as pcli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    name = flags[0] if flags[0] in ("bgen", "chrx") else "bed"
    flags = flags[1:] if flags[0] in ("bgen", "chrx") else flags
    d, src = datasets[name]
    argv = src + ["--phenoFile", f"{d}/pheno.txt", "--covarFile", f"{d}/covar.txt",
                  "--ignore-pred"]
    if "--step" not in flags:
        argv = ["--step", "2"] + argv
    argv += flags
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    pj, pp = str(tmp_path / "j"), str(tmp_path / "p")
    ej, fj = _outcome(jcli.main, argv, pj)
    ep, fp = _outcome(pcli.main, argv, pp)
    assert ep == ej, (ep, ej)
    assert ep != "NotImplementedError"
    assert sorted(fj) == sorted(fp), (sorted(fj), sorted(fp))
    for k in fj:
        assert _same(fj[k], fp[k], pj, pp), k
    print(f"{' '.join(flags)} on {name}: "
          + (f"both raise {ep}" if ep else f"{len(fp)} files the same"))
