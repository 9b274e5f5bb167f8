"""Tests of the port's dosage decoders: the BGEN dosage decoder
(io/csrc/bgen_dosages.cpp, through io/bgen.py decode_block) against the
JAX package's per-variant reader (regenie_tpu/io/bgen.py decode_variant)
and the PGEN dosage entry (io/csrc/pgen_bytes.cpp pgen_dosages) against
the JAX package's PgenDecoder.dosages, bit for bit, on every layout, bit
depth, phase, compression and dosage-track type; and the records each
rejects."""

import struct
import zlib

import numpy as np
import pytest

from chip_smoke import _difflist, _pack2, _vints, write_bgen_dataset, zstd_compressor
from regenie_tpu_torch.io import bgen as tbg
from regenie_tpu_torch.io.native import pgen_dosages_native
from regenie_tpu_torch.io.pgen import PgenDecoder, open_pgen

# (layout, bits, phased, compression)
ENCODINGS = [
    (2, 8, False, 1), (2, 8, False, 0), (2, 8, True, 2), (2, 16, True, 0),
    (2, 16, False, 2), (2, 3, True, 1), (2, 10, False, 2), (2, 32, False, 1),
    (1, 16, False, 1), (1, 16, False, 0),
]


def _bits_eq(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool((a.view(np.int64) == b.view(np.int64)).all())


@pytest.fixture(scope="module")
def jbgen():
    pytest.importorskip("jax")
    from regenie_tpu.io import bgen

    return bgen


@pytest.mark.parametrize("layout,bits,phased,compression", ENCODINGS)
def test_bgen_decoder_equals_jax_reader(tmp_path, jbgen, layout, bits, phased,
                                        compression):
    """decode_block (the C++ decoder on one thread per CPU) equals the JAX
    package's decode_variant bit for bit, dosages and INFO numerators, on
    every sample and on a kept subset, ref-last and --ref-first, on
    blocks in file order and not; the port's own plain decode_variant
    equals the JAX package's too."""
    kw = {}
    if compression == 2:
        try:
            kw["compress"] = zstd_compressor()
        except OSError:
            pytest.skip("libzstd.so.1 is not installed")
    N, M = 301, 40
    path = write_bgen_dataset(str(tmp_path), seed=layout * 100 + bits, N=N,
                              chroms=((1, M),), P=1, n_inc=0, n_cov=1,
                              miss=0.05, uncertain=0.5, bits=bits,
                              phased=phased, layout=layout,
                              compression=compression, **kw)
    bf, jf = tbg.open_bgen(path), jbgen.open_bgen(path)
    assert (bf.layout, bf.compression) == (layout, compression)
    keep = np.sort(np.random.default_rng(0).choice(N, 150, replace=False))
    order = list(range(M))
    scattered = [7, 3, 39, 0, 12]
    for ref_first in (False, True):
        for kp in (None, keep):
            ds, iv = tbg.decode_block(bf, order, kp, ref_first)
            ds2, iv2 = tbg.decode_block(bf, scattered, kp, ref_first)
            for v in range(M):
                want = jbgen.decode_variant(jf, v, kp, ref_first)
                assert _bits_eq(ds[v], want[0]) and _bits_eq(iv[v], want[1]), v
                plain = tbg.decode_variant(bf, v, kp, ref_first)
                assert _bits_eq(plain[0], want[0]) and _bits_eq(plain[1], want[1])
            for k, v in enumerate(scattered):
                assert _bits_eq(ds2[k], ds[v]) and _bits_eq(iv2[k], iv[v])
    assert (ds == -3).any() and ((ds > 0) & (ds < 2) & (ds != 1)).any()
    bf.close()


def _tiny_record_bgen(path, records, N=4):
    """A layout-2 zlib BGEN of hand-made genotype block bodies (one
    variant each); a record given as bytes is written as is, after the
    size fields."""
    ids = [f"I{i}" for i in range(N)]
    lsi = 8 + sum(2 + len(s) for s in ids)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<IIII", 20 + lsi, 20, len(records), N) + b"bgen")
        fh.write(struct.pack("<I", 1 | (2 << 2) | (1 << 31)))
        fh.write(struct.pack("<II", lsi, N)
                 + b"".join(struct.pack("<H", len(s)) + s.encode() for s in ids))
        for v, (body, z) in enumerate(records):
            rs = f"r{v}".encode()
            fh.write(struct.pack("<H", len(rs)) + rs + struct.pack("<H", len(rs)) + rs
                     + struct.pack("<H", 1) + b"1" + struct.pack("<IH", 10 + v, 2)
                     + struct.pack("<I", 1) + b"A" + struct.pack("<I", 1) + b"C"
                     + struct.pack("<II", len(z) + 4, len(body)) + z)


def test_bgen_decoder_rejects_bad_records(tmp_path):
    """A record that does not inflate, one whose probabilities reach past
    it, one with a bit depth of 0 and one with three alleles each raise
    RuntimeError naming the variant; the good variants still decode."""
    N = 4
    good = (struct.pack("<IHBB", N, 2, 2, 2) + bytes([2] * N) + bytes([0, 8])
            + bytes([100, 50] * N))
    short = good[:-3]
    bits0 = good[: 9 + N] + bytes([0]) + good[10 + N :]
    alleles3 = struct.pack("<IHBB", N, 3, 2, 2) + good[8:]
    recs = [(good, zlib.compress(good)), (good, b"not zlib data"),
            (short, zlib.compress(short)), (bits0, zlib.compress(bits0)),
            (alleles3, zlib.compress(alleles3))]
    path = str(tmp_path / "bad.bgen")
    _tiny_record_bgen(path, recs, N)
    bf = tbg.open_bgen(path)
    ds, iv = tbg.decode_block(bf, [0], None, False)
    np.testing.assert_allclose(ds, [[1.0 * 50 / 255 + 2 * 100 / 255] * N])
    for v, why in ((1, "inflate"), (2, "reach past"), (3, "bit depth"),
                   (4, "allele count")):
        with pytest.raises(RuntimeError, match=f"variant r{v} cannot be decoded.*{why}"):
            tbg.decode_block(bf, [0, v], None, False)
    with pytest.raises(RuntimeError, match="4 of 5 variants of the block rejected"):
        tbg.decode_block(bf, range(5), None, False)
    bf.close()


# ---------------------------------------------------------------------------
# PGEN dosage tracks
# ---------------------------------------------------------------------------


def _deltalist(ids, N):
    """A PGEN deltalist: a difflist without its 2-bit codes."""
    L = len(ids)
    head, _ = _vints([L])
    if L == 0:
        return head.tobytes()
    full = _difflist(ids, np.zeros(L, np.uint8), N)
    # drop the raregeno bytes, which sit before the vint deltas
    sid_bytes = (int(N).bit_length() + 7) // 8
    group_ct = (L + 63) // 64
    cut = len(head) + group_ct * sid_bytes + group_ct - 1
    return full[:cut] + full[cut + (L + 3) // 4 :]


def _phase_track(rng, codes, explicit):
    """A hardcall-phase aux track over the hets: bit 0 says whether a
    phasepresent bitarray (bits 1..het_ct) precedes the phase bits."""
    het_ct = int((codes == 1).sum())
    first = np.zeros(1 + het_ct // 8, np.uint8)
    bits = np.zeros(8 * len(first), np.uint8)
    bits[0] = explicit
    bits[1 : het_ct + 1] = rng.integers(0, 2, het_ct)
    first = np.packbits(bits, bitorder="little")
    rest = b""
    if explicit:
        pp = int(bits[1 : het_ct + 1].sum())
        rest = rng.integers(0, 256, (pp + 7) // 8).astype(np.uint8).tobytes()
    return first.tobytes() + rest


def _dosage_pgen(path, N=300):
    """A PGEN (storage mode 0x10, 8-bit vrtypes) whose records carry every
    dosage track type on several hardcall record types: dense (0x40, with
    65535 missing), deltalist (0x20), bitarray (0x60), after an explicit
    or implicit hardcall-phase track (0x10), on 2-bit, onebit, difflist,
    all-hom-ref and LD-compressed records."""
    rng = np.random.default_rng(N)
    recs, vts = [], []

    def dense():
        v = rng.integers(0, 32769, N).astype("<u2")
        v[rng.random(N) < 0.05] = 65535
        return v.tobytes()

    def delta():
        ids = np.sort(rng.choice(N, 90, replace=False))
        return _deltalist(ids, N) + rng.integers(0, 32769, 90).astype("<u2").tobytes()

    def bitarray():
        present = rng.random(N) < 0.3
        return (np.packbits(present.astype(np.uint8), bitorder="little").tobytes()
                + rng.integers(0, 32769, int(present.sum())).astype("<u2").tobytes())

    g = rng.integers(0, 4, N).astype(np.uint8)
    two_bit = _pack2(g).tobytes()
    for vt, track in ((0x40, dense), (0x20, delta), (0x60, bitarray)):
        vts.append(vt)
        recs.append(two_bit + track())
    for vt, explicit, track in ((0x50, 1, dense), (0x30, 0, delta),
                                (0x70, 1, bitarray)):
        vts.append(vt)
        recs.append(two_bit + _phase_track(rng, g, explicit) + track())
    bits = rng.integers(0, 2, N).astype(np.uint8)
    ids = np.sort(rng.choice(N, 20, replace=False))
    onebit = (b"\x01" + np.packbits(bits, bitorder="little").tobytes()
              + _difflist(ids, rng.integers(0, 4, 20).astype(np.uint8), N))
    vts.append(0x01 | 0x40)
    recs.append(onebit + dense())
    ids = np.sort(rng.choice(N, 30, replace=False))
    vts.append(0x02 | 0x20)  # LD against the onebit record
    recs.append(_difflist(ids, rng.integers(0, 4, 30).astype(np.uint8), N) + delta())
    vts.append(0x03 | 0x60)  # inverted LD
    recs.append(_difflist(ids[:5], rng.integers(0, 4, 5).astype(np.uint8), N)
                + bitarray())
    vts.append(0x05 | 0x20)  # all hom-ref
    recs.append(delta())
    vts.append(0x04 | 0x40)  # difflist against hom-ref
    recs.append(_difflist(ids, rng.integers(0, 4, 30).astype(np.uint8), N) + dense())
    vts.append(0x00)  # no dosage track
    recs.append(two_bit)
    M = len(recs)
    index = 8 + M + 3 * M
    with open(path, "wb") as fh:
        fh.write(b"\x6c\x1b\x10" + struct.pack("<II", M, N) + b"\x06")
        fh.write(struct.pack("<Q", 12 + index))
        fh.write(bytes(vts))
        fh.write(b"".join(struct.pack("<I", len(r))[:3] for r in recs))
        fh.write(b"".join(recs))
    return M


@pytest.mark.parametrize("N", [300, 70001])
def test_pgen_dosages_equal_jax(tmp_path, N):
    """pgen_dosages equals the JAX package's PgenDecoder.dosages (and the
    port's own plain twin) bit for bit on every track type, on all
    samples and on a subset, in file order and reversed; with N past
    65,535 the lists' sample ids take 3 bytes."""
    jpgen = pytest.importorskip("regenie_tpu.io.pgen")
    path = str(tmp_path / "dos.pgen")
    M = _dosage_pgen(path, N)
    pf = open_pgen(path)
    jd = jpgen.PgenDecoder(jpgen.open_pgen(path))
    want = np.stack([jd.dosages(v) for v in range(M)])
    dec = PgenDecoder(pf)
    assert _bits_eq(np.stack([dec.dosages(v) for v in range(M)]), want)
    assert (want == -3).any() and (want % 1 != 0).any()
    keep = np.sort(np.random.default_rng(2).choice(N, N // 3, replace=False))
    for order in (np.arange(M), np.arange(M)[::-1]):
        assert _bits_eq(pgen_dosages_native(pf, order), want[order])
        assert _bits_eq(pgen_dosages_native(pf, order, keep), want[order][:, keep])
    pf.close()


def test_pgen_dosages_reject_bad_records(tmp_path):
    """A multiallelic record, and a dosage track that runs past the end of
    the file, fail the block with RuntimeError."""
    path = str(tmp_path / "dos.pgen")
    M = _dosage_pgen(path)
    pf = open_pgen(path)
    pgen_dosages_native(pf, np.arange(M))
    pf.vrtypes = pf.vrtypes.copy()
    pf.vrtypes[1] |= 8
    with pytest.raises(RuntimeError, match="PGEN dosage decoding rejected 1 of 2"):
        pgen_dosages_native(pf, [0, 1])
    pf.vrtypes[1] &= 0xF7
    pf.fpos = pf.fpos.copy()
    pf.fpos[0] = len(pf._data) - (300 + 3) // 4  # the 2-bit codes fit, not the track
    with pytest.raises(RuntimeError, match="rejected 1 of 1"):
        pgen_dosages_native(pf, [0])
    pf.close()
