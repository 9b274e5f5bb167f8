"""Tests of the port's PGEN hardcall input: the native block decoder
(regenie_tpu_torch/io/csrc/pgen_bytes.cpp) against the JAX package's
repack of decoded ALT counts into BED codes, byte for byte (with and
without --ref-first and --remove, on LD-compressed records), and against
the plain PgenDecoder on a file with every record type; the Step-2 CLI
on a chrX PGEN against `REGENIE_TPU_FUSED=1 python -m regenie_tpu`, and
Step 1 against `python -m regenie_tpu --step 1` (both on the CPU, in
this process)."""

import os
import struct

import numpy as np
import pytest

from chip_smoke import _difflist, _pack2, chrx_positions, write_pgen_dataset
from regenie_tpu_torch.io.bed import decode_bed_bytes
from regenie_tpu_torch.io.native import pgen_bed_bytes_native
from regenie_tpu_torch.io.pgen import PgenDecoder, open_pgen

CHROMS = ((1, 150), ("X", 100))
POS = {"X": chrx_positions(100, 12, 12)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_pgen"))
    prefix = write_pgen_dataset(d, seed=9, N=450, chroms=CHROMS, P=3, n_inc=1,
                                n_cov=3, na_rate=0.1, n_remove=11,
                                effect_sd=0.5, positions=POS, ld_diff=0.02)
    return d, prefix


def _jax_repack(argv):
    """The JAX package's fused PGEN block bytes (read_block_raw: decoded
    ALT counts repacked through its LUT into BED codes on the kept axis)
    for every block of a run set up by `argv`, unpadded."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.io.geno import make_blocks
    from regenie_tpu.prep import prepare
    from regenie_tpu.run_step2 import Step2Engine

    params = jcli.args_to_params(jcli.build_parser().parse_args(argv))
    params.test_mode = True
    rd = prepare(params, log=lambda *a: None)
    eng = Step2Engine(params, rd.geno, rd.pheno, None, lambda *a: None)
    nb = (params.n_samples + 3) // 4
    blocks = make_blocks(rd.geno, params.block_size)
    return rd.geno, blocks, [np.asarray(eng.read_block_raw(b))[:, :nb]
                             for _, b in blocks]


@pytest.mark.parametrize("ref_first", [False, True])
@pytest.mark.parametrize("remove", [False, True])
def test_bytes_equal_jax_repack(dataset, ref_first, remove, monkeypatch):
    """The port's PGEN block bytes (GenoData.read_block_bytes, module
    io/csrc/pgen_bytes.cpp) equal the JAX package's repack byte for byte,
    on a file whose LD-compressed records (plain and inverted) are a
    quarter of its variants, with and without --ref-first (which PGEN's
    own REF/ALT make a no-op in both packages) and --remove."""
    pytest.importorskip("jax")
    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.io.geno import make_blocks
    from regenie_tpu_torch.prep import prepare

    d, prefix = dataset
    argv = ["--step", "2", "--pgen", prefix, "--phenoFile", f"{d}/pheno.txt",
            "--ignore-pred", "--bsize", "64", "--out", f"{d}/x"]
    if ref_first:
        argv.append("--ref-first")
    if remove:
        argv += ["--remove", f"{d}/remove.txt"]
    jgd, jblocks, want = _jax_repack(argv)
    params = cli.args_to_params(cli.build_parser().parse_args(argv))
    params.test_mode = True
    gd = prepare(params, log=lambda *a: None).geno
    assert gd._keep_all_samples != remove
    vrtypes = gd._pgen.pf.vrtypes
    assert (vrtypes == 2).sum() > 20 and (vrtypes == 3).sum() > 20
    blocks = make_blocks(gd, params.block_size)
    assert len(blocks) == len(jblocks) == 5
    for (_, bsnps), w in zip(blocks, want):
        np.testing.assert_array_equal(gd.read_block_bytes(bsnps), w)


def _hand_pgen(path, N, fixed=False, dosage=False):
    """A PGEN holding every hardcall record type: vrtype 0 (2-bit), 2 and
    3 (LD-compressed, plain and inverted), 1 (onebit with exceptions), 4,
    6 and 7 (difflists against hom-ref, hom-alt and missing), 5 (all
    hom-ref), then LD against a difflist record; or with fixed=True a
    storage-mode 0x02 file of 2-bit records. dosage=True stores 8-bit
    vrtypes and gives the first record a dense dosage track (0x40).
    Returns the expected 2-bit codes [M, N]."""
    rng = np.random.default_rng(N)
    g0 = rng.integers(0, 4, N).astype(np.uint8)
    if fixed:
        codes = rng.integers(0, 4, (5, N)).astype(np.uint8)
        with open(path, "wb") as fh:
            fh.write(b"\x6c\x1b\x02" + struct.pack("<II", 5, N) + b"\x00")
            for c in codes:
                fh.write(_pack2(c).tobytes())
        return codes

    def diffs(base, k):
        ids = np.sort(rng.choice(N, size=k, replace=False))
        new = rng.integers(0, 4, k).astype(np.uint8)
        out = base.copy()
        out[ids] = new
        return out, _difflist(ids, new, N)

    swap = np.array([2, 1, 0, 3], np.uint8)
    recs, codes, vt = [], [], []

    def add(v, c, rec):
        vt.append(v)
        codes.append(c)
        recs.append(rec)

    add(0, g0, _pack2(g0).tobytes())
    add(2, *diffs(g0, 150))
    add(3, *diffs(swap[g0], 70))
    bits = rng.integers(0, 2, N).astype(np.uint8)
    ob, exc = diffs(bits, 40)  # base 0, delta 1: codes 0/1, exceptions any
    add(1, ob, b"\x01" + np.packbits(bits, bitorder="little").tobytes() + exc)
    zero = np.zeros(N, np.uint8)
    add(4, *diffs(zero, 90))
    add(5, zero, b"")
    d6, r6 = diffs(np.full(N, 2, np.uint8), 65)
    add(6, d6, r6)
    d7, r7 = diffs(np.full(N, 3, np.uint8), 64)
    add(7, d7, r7)
    add(2, *diffs(d7, 1))
    add(2, *diffs(d7, 0))
    M = len(recs)
    if dosage:
        vt[0] |= 0x40
        recs[0] += bytes(2 * N)
    lens = [len(r) for r in recs]
    index = 8 + (M if dosage else (M + 1) // 2) + 3 * M
    with open(path, "wb") as fh:
        fh.write(b"\x6c\x1b\x10" + struct.pack("<II", M, N)
                 + (b"\x06" if dosage else b"\x02"))
        fh.write(struct.pack("<Q", 12 + index))
        v = np.zeros(2 * ((M + 1) // 2), np.uint8)
        v[:M] = vt
        fh.write(v[:M].tobytes() if dosage else (v[0::2] | (v[1::2] << 4)).tobytes())
        fh.write(b"".join(struct.pack("<I", n)[:3] for n in lens))
        fh.write(b"".join(recs))
    return np.stack(codes)


@pytest.mark.parametrize("N,fixed", [(300, False), (70001, False), (301, True)])
def test_decoder_equals_plain(tmp_path, N, fixed):
    """Every record type, and storage mode 0x02: the native decoder's BED
    bytes decode to the plain PgenDecoder's (and the JAX package's) codes,
    on all samples and on a subset, on each thread split; with N past
    65,535 the difflists' sample ids take 3 bytes."""
    path = str(tmp_path / "hand.pgen")
    want = _hand_pgen(path, N, fixed)
    pf = open_pgen(path)
    dec = PgenDecoder(pf)
    M = len(want)
    plain = np.stack([dec.decode(v) for v in range(M)])
    np.testing.assert_array_equal(plain, want)
    try:
        from regenie_tpu.io import pgen as jpgen
    except ImportError:
        jpgen = None
    if jpgen is not None:
        jd = jpgen.PgenDecoder(jpgen.open_pgen(path))
        np.testing.assert_array_equal(np.stack([jd.decode(v) for v in range(M)]), want)
    alt = np.where(want == 3, -3, want.astype(np.int64))
    keep = np.sort(np.random.default_rng(1).choice(N, N // 2, replace=False))
    for order in (np.arange(M), np.arange(M)[::-1], np.array([M - 1])):
        got = decode_bed_bytes(pgen_bed_bytes_native(pf, order), N)
        np.testing.assert_array_equal(got, alt[order])
        got = decode_bed_bytes(pgen_bed_bytes_native(pf, order, keep), len(keep))
        np.testing.assert_array_equal(got, alt[order][:, keep])
    pf.close()


def test_decoder_rejects_bad_records(tmp_path):
    """A multiallelic record or one that runs past the end of the file
    fails the whole block with RuntimeError; the others still decode."""
    path = str(tmp_path / "hand.pgen")
    _hand_pgen(path, 300)
    pf = open_pgen(path)
    pf.vrtypes = pf.vrtypes.copy()
    pf.vrtypes[4] |= 8
    with pytest.raises(RuntimeError, match="rejected 1 of 3 variants"):
        pgen_bed_bytes_native(pf, [0, 4, 5])
    pgen_bed_bytes_native(pf, [0, 5])
    pf.fpos = pf.fpos.copy()
    pf.fpos[0] = len(pf._data) - 10
    with pytest.raises(RuntimeError, match="rejected 2 of 2 variants"):
        pgen_bed_bytes_native(pf, [0, 1])
    pf.close()


@pytest.mark.parametrize("step", ["1", "2"])
def test_pgen_with_dosages_raises(tmp_path, monkeypatch, step):
    """A PGEN with dosage tracks is read as dosages in both steps (the
    JAX package's dense path); one whose dosage track runs past the end
    of the file raises RuntimeError in both steps, and Step 1 writes no
    prediction list."""
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    pre = str(tmp_path / "dos")
    M = len(_hand_pgen(pre + ".pgen", 200, dosage=True))
    assert open_pgen(pre + ".pgen").vrtypes[0] == 0x40
    with open(pre + ".pvar", "w") as fh:
        fh.write("#CHROM\tPOS\tID\tREF\tALT\n")
        fh.write("".join(f"1\t{100 + v}\tv{v}\tA\tC\n" for v in range(M)))
    with open(pre + ".psam", "w") as fh:
        fh.write("#IID\tSEX\n" + "".join(f"I{i}\t{1 + i % 2}\n" for i in range(200)))
    with open(tmp_path / "ph.txt", "w") as fh:
        fh.write("FID IID Y1\n" + "".join(f"I{i} I{i} {i % 7}\n" for i in range(200)))
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    argv = ["--step", step, "--pgen", pre, "--phenoFile", str(tmp_path / "ph.txt"),
            "--bsize", "5"] + (["--ignore-pred"] if step == "2" else [])
    if step == "1":
        # v0's dosage track is all 0 over random hardcalls: read as
        # dosages, it has no variance
        with pytest.raises(ValueError, match="SNP v0 has low variance"):
            cli.main(argv + ["--out", str(tmp_path / "ok")])
    else:
        cli.main(argv + ["--out", str(tmp_path / "ok")])
        rows = open(tmp_path / "ok_Y1.regenie").read().splitlines()
        assert "INFO" in rows[0].split()  # dosage mode
        assert len(rows) > 1 and not rows[1].startswith("1 100 ")
    # cut the file inside the first record's dosage track
    with open(pre + ".pgen", "r+b") as fh:
        fh.truncate(open_pgen(pre + ".pgen").fpos[0] + (200 + 3) // 4 + 10)
    with pytest.raises(RuntimeError, match="PGEN dosage decoding rejected"):
        cli.main(argv + ["--out", str(tmp_path / "o")])
    assert not os.path.exists(str(tmp_path / "o_pred.list"))


# ---------------------------------------------------------------------------
# the CLIs against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted(dataset):
    """JAX Step-1 LOCO predictions on the PGEN dataset."""
    pytest.importorskip("jax")
    from regenie_tpu import cli as jcli

    d, prefix = dataset
    mp = pytest.MonkeyPatch()
    mp.setenv("REGENIE_TPU_PLATFORM", "cpu")
    try:
        jcli.main(["--step", "1", "--pgen", prefix, "--phenoFile",
                   f"{d}/pheno.txt", "--covarFile", f"{d}/covar.txt",
                   "--remove", f"{d}/remove.txt", "--bsize", "50",
                   "--out", f"{d}/jfit"])
    finally:
        mp.undo()
    return d, prefix


@pytest.mark.parametrize("scenario", ["plain", "htp", "pred", "ref_first"])
def test_step2_matches_jax(fitted, scenario, monkeypatch):
    """Step 2 QT on the chrX PGEN (LD-compressed records, --remove, an
    incomplete trait): the port writes what the JAX package's fused path
    writes, within rel 1e-9 field by field (_assert_rows_equiv)."""
    from regenie_tpu import cli as jcli
    from test_torch_step2 import _assert_rows_equiv

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    d, prefix = fitted
    extra = {"plain": ["--ignore-pred"], "htp": ["--ignore-pred", "--htp", "P"],
             "pred": ["--pred", f"{d}/jfit_pred.list"],
             "ref_first": ["--ignore-pred", "--ref-first"]}[scenario]
    argv = ["--step", "2", "--pgen", prefix, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--bsize", "64", *extra]
    monkeypatch.setenv("REGENIE_TPU_FUSED", "1")
    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    jcli.main(argv + ["--out", jx])
    assert "fused packed-bytes scorer active (QT/PGEN" in open(f"{jx}.log").read()
    cli.main(argv + ["--out", pt])
    assert "fused packed-bytes scorer on cpu (PGEN" in open(f"{pt}.log").read()
    for ph in ("Y1", "Y2", "Y3"):
        _assert_rows_equiv(f"{jx}_{ph}.regenie", f"{pt}_{ph}.regenie")
    n = len(open(f"{pt}_Y1.regenie").read().splitlines()) - 1
    assert 200 < n <= 250


def test_step1_matches_jax(fitted, monkeypatch):
    """Step 1 QT on the PGEN: the port's .loco files equal the JAX
    package's, or each value within one unit of its sixth significant
    digit (assert_loco_equiv, as for BED)."""
    from test_torch_step1_cli import _port, assert_loco_equiv

    d, prefix = fitted
    _port(["--step", "1", "--pgen", prefix, "--phenoFile", f"{d}/pheno.txt",
           "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
           "--bsize", "50", "--out", f"{d}/pfit"], monkeypatch)
    for p in (1, 2, 3):
        assert_loco_equiv(f"{d}/jfit_{p}.loco", f"{d}/pfit_{p}.loco")
    rows = open(f"{d}/pfit_1.loco").read().splitlines()
    assert [r.split()[0] for r in rows[1:]] == [str(c) for c in range(1, 24)]


def test_int8_gap_is_the_data_not_the_decoder(tmp_path, monkeypatch):
    """Why the PGEN chrX slice's blocks sit ~9x further from the float64
    plain path than the BED slice's (|dLOG10P| 1.47e-06 against 1.70e-07
    at N = 400,000 on an NVIDIA H100): its PGEN (seed 6, chromosome 1 and chrX,
    a quarter of the records LD-compressed, every other one inverted) at
    N = 2,000 with a BED of the same hardcalls beside it
    (write_pgen_dataset's bed_prefix). The decoder's BED-coded bytes equal
    the BED's block for block, so both files give the same LOG10P on the
    float64 route and the same int8-operand gaps (the int8 limbs selected
    on the CPU, plain integer products): the decoder is exact. The gap
    sits on the variants whose ALT frequency exceeds 0.5 (the inverted
    records; a quantitative trait's test never flips to the minor allele,
    and the int8 fold's centring cancels most for them): at least 4x the
    rest of the block, which stays at the BED slice's level."""
    from chip_smoke import write_dataset
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.run_step2 import Step2Engine, open_engine

    d, B = str(tmp_path), 256
    write_pgen_dataset(d, seed=6, N=2000, chroms=((1, B), ("X", B)), P=50,
                       n_inc=10, n_cov=19, positions={"X": chrx_positions(B, B // 8)},
                       bed_prefix=f"{d}/same")
    os.makedirs(f"{d}/slice")
    write_dataset(f"{d}/slice", seed=1, N=2000, chroms=((1, 2 * B),), P=50,
                  n_inc=10, n_cov=19)

    def run(src, dd, i8):
        argv = ["--step", "2", *src, "--phenoFile", f"{dd}/pheno.txt",
                "--covarFile", f"{dd}/covar.txt", "--ignore-pred", "--bsize",
                str(B), "--out", f"{dd}/x"]
        params = cli.args_to_params(cli.build_parser().parse_args(argv))
        with monkeypatch.context() as m:
            if i8:
                m.setattr(fsc, "split_mode", lambda on_gpu: "i8")
            eng, blocks = open_engine(params, log=lambda *a: None, device="cpu")
            eng = Step2Engine(params, eng.gd, eng.pd, None, eng.log, "cpu")
        assert eng.split == ("i8" if i8 else False)
        out = []
        for chrom, bsnps in blocks:
            eng.prep_chrom(chrom)
            raw = eng.read_block_raw(bsnps)
            out.append((np.asarray(raw), eng.test_raw_block_fused(raw, bsnps)[0]))
        eng.gd.close()
        return out

    runs = {(name, i8): run(src, dd, i8)
            for name, src, dd in (("pgen", ["--pgen", f"{d}/geno"], d),
                                  ("bed", ["--bed", f"{d}/same"], d),
                                  ("slice", ["--bed", f"{d}/slice/geno"], f"{d}/slice"))
            for i8 in (False, True)}
    for b in range(2):
        (rp, p64), (rb, b64) = runs["pgen", False][b], runs["bed", False][b]
        assert np.array_equal(rp[:, : rb.shape[1]], rb)
        assert np.array_equal(p64.logp, b64.logp, equal_nan=True)
        gaps = {}
        for name in ("pgen", "bed", "slice"):
            g = np.abs(runs[name, True][b][1].logp - runs[name, False][b][1].logp)
            gaps[name] = (g, runs[name, False][b][1].af1 > 0.5)
        assert np.array_equal(gaps["pgen"][0], gaps["bed"][0], equal_nan=True)
        g, hi = gaps["bed"]
        g_slice = np.nanmax(gaps["slice"][0])
        print(f"block {b}: {int(hi.sum())} of {len(hi)} variants with ALT frequency "
              f"> 0.5: int8 |dLOG10P| {np.nanmax(g[hi]):.3e} there, "
              f"{np.nanmax(g[~hi]):.3e} elsewhere; BED slice data {g_slice:.3e}")
        assert hi.sum() == B // 8
        assert np.nanmax(g[hi]) > 4 * np.nanmax(g[~hi])
        assert np.nanmax(g[~hi]) < 2 * g_slice
