"""Tests of the port's BGEN profiling entry point
(regenie_tpu_torch.scripts.profile_bgen) and its seven kernel variants
(ops/csrc/profile_bgen.cu): on the CPU, each variant's plain version
against the JAX package's own profiling kernels of scripts/profile_bgen.py,
run unchanged in Pallas interpret mode, on the script's inputs and on
planes with missing samples; the two plane layouts; the port's script end
to end at a tiny shape; the wrappers' input checks; and, with marker
`cuda`, the kernels against their plain versions. On the GPU machine,
which has no JAX, run the card's tests with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_profile_bgen.py
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from regenie_tpu_torch.ops import kernels
from regenie_tpu_torch.scripts import profile_bgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = list(kernels.PROFILE_BGEN_VARIANTS)
# the JAX script's kernel functions, in the order its modes time them, and
# the port's variant of each
TPU_FUNCTIONS = {
    "kern_base": "i32_shift_q3", "kern_noq": "i32_shift_noq",
    "kern_u8": "u8_shift_q3",
    "kern_sep": "i32_shift_q3", "kern_sep_noq": "i32_shift_noq",
    "kern_sep_merge": "u8_unshift_q3_stacked",
    "make_base3": "u8_unshift_q3", "make_base2": "u8_unshift_e2",
    "make_base4": "u8_unshift_dhl",
}
B_TPU, N_TPU = 64, 1024


@pytest.fixture(scope="module")
def tpu_runs():
    """scripts/profile_bgen.py loaded unchanged and run in its three
    variant modes at B=64, N=1024 with 64-bit types off (as the script
    runs), jax.experimental.pallas.pallas_call in interpret mode and the
    module's timeit replaced by a recorder: {function name: (the jitted
    call, its inputs, its float32 outputs)}. Tests that take it skip where
    JAX is not installed."""
    pytest.importorskip("jax")
    import jax
    from jax.experimental import pallas as jpl

    spec = importlib.util.spec_from_file_location(
        "tpu_profile_bgen", os.path.join(REPO, "scripts", "profile_bgen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []

    def record(fn, *args, **_):
        calls.append((fn, args, tuple(np.asarray(o) for o in fn(*args))))
        return 1.0

    mod.timeit = record
    mp = pytest.MonkeyPatch()
    mp.setattr(jpl, "pallas_call", functools.partial(jpl.pallas_call, interpret=True))
    mp.setattr(sys, "argv", ["profile_bgen.py", "variants", str(B_TPU), str(N_TPU)])
    try:
        with jax.enable_x64(False):
            for mode in ("variants", "variants2", "variants3"):
                sys.argv[1] = mode
                getattr(mod, f"{mode}_main")()
    finally:
        mp.undo()
    assert len(calls) == len(TPU_FUNCTIONS)
    return dict(zip(TPU_FUNCTIONS, calls))


def _port_inputs(args):
    """The JAX call's inputs as the port takes them: k0, k1 views of a
    [B, 2, Np] block (row 9) or the two [B, Np] planes (rows 10, 11), and
    the int8 limbs."""
    t = [torch.from_numpy(np.array(a)) for a in args]
    if len(t) == 3:
        return t[0][:, 0], t[0][:, 1], t[1], t[2]
    return tuple(t)


def _missing_planes(args, seed):
    """The JAX call's planes with about 2% of the samples set to the 255
    sentinel and about 2% more to pairs with k0 + k1 > 255 (both missing),
    in the call's layout."""
    rng = np.random.default_rng(seed)
    planes = [np.array(a) for a in args[:-2]]
    k0, k1 = (planes[0][:, 0], planes[0][:, 1]) if len(planes) == 1 else planes
    n = N_TPU
    u = rng.random(k0[:, :n].shape)
    k0[:, :n][u < 0.02] = 255
    k1[:, :n][u < 0.02] = 255
    over = (u >= 0.02) & (u < 0.04)
    k0[:, :n][over] = rng.integers(56, 256, size=int(over.sum()))
    k1[:, :n][over] = 255
    assert ((k0[:, :n].astype(int) + k1[:, :n]) > 255).mean() > 0.03
    return planes


def _assert_equal_exact(got, want):
    """The port's int64 products equal the JAX float32 ones, which are exact
    integers here (every partial sum below 2^24)."""
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == w.shape
        assert np.abs(w).max() <= 2**24
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("func", list(TPU_FUNCTIONS))
def test_profile_bgen_plain_matches_tpu_script_kernel(tpu_runs, func):
    """Each of the JAX script's nine timed kernels (seven functions) in
    interpret mode, on the script's own inputs (no missing sample) at
    N=1024: the port's variant, through its wrapper on CPU tensors (the
    plain version, no launch), gives exactly its outputs."""
    _, args, want = tpu_runs[func]
    n0 = {k: w.launches for k, w in kernels.WRAPPERS.items()}
    got = kernels.PROFILE_BGEN[TPU_FUNCTIONS[func]](*_port_inputs(args))
    assert {k: w.launches for k, w in kernels.WRAPPERS.items()} == n0
    _assert_equal_exact(got, want)
    assert all(np.abs(w).max() > 0 for w in want[:2])


@pytest.mark.parametrize("func", list(TPU_FUNCTIONS))
def test_profile_bgen_plain_matches_tpu_script_with_missing(tpu_runs, func):
    """The same nine kernels called again on planes holding the 255
    sentinel and other pairs with k0 + k1 > 255 (about 4% missing), which
    the script's own inputs never have: the port's variant gives exactly
    their outputs, m included."""
    import jax

    fn, args, _ = tpu_runs[func]
    planes = _missing_planes(args, seed=list(TPU_FUNCTIONS).index(func))
    with jax.enable_x64(False):
        want = tuple(np.asarray(o) for o in fn(*planes, *args[-2:]))
    got = kernels.PROFILE_BGEN[TPU_FUNCTIONS[func]](*_port_inputs([*planes, *args[-2:]]))
    _assert_equal_exact(got, want)
    assert np.abs(want[2]).max() > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_profile_bgen_layouts_agree(variant):
    """The row-9 layout (k0, k1 views of one [B, 2, Np] buffer, row stride
    2 Np) and the row-10 layout (two contiguous [B, Np] tensors) give the
    same products, and the variant's plain version equals the direct
    int64 sums of s(x) = x - 128 per sample."""
    rng = np.random.default_rng(21)
    B, Np, Cw, Cq = 7, 48, 32, 16
    planes = torch.from_numpy(rng.integers(0, 256, (B, 2, Np), dtype=np.uint8))
    wp = torch.from_numpy(rng.integers(-128, 128, (Np, Cw), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-128, 128, (Np, Cq), dtype=np.int8))
    fn = kernels.PROFILE_BGEN[variant]
    packed = fn(planes[:, 0], planes[:, 1], wp, wq)
    sep = fn(planes[:, 0].contiguous(), planes[:, 1].contiguous(), wp, wq)
    assert planes[:, 0].stride() == (2 * Np, 1)
    for a, b in zip(packed, sep):
        assert torch.equal(a, b)

    shift_m, q, _ = kernels.PROFILE_BGEN_VARIANTS[variant]
    k0, k1 = planes[:, 0].long(), planes[:, 1].long()
    miss = (k0 + k1) > 255
    k0, k1, miss = k0.masked_fill(miss, 0), k1.masked_fill(miss, 0), miss.long()
    d = 2 * k0 + k1
    W, Q = wp.long(), wq.long()
    want = [(k0 - 128) @ W, (k1 - 128) @ W, (miss - 128 * shift_m) @ W]
    zero = torch.zeros((B, Cq), dtype=torch.int64)
    if q == "q3":
        want += [(x - 128) @ Q for x in ((d * d) & 255, ((d * d) >> 8) & 255,
                                         (d * d) >> 16)]
    elif q == "e2":
        e2 = (d - 255) ** 2
        want += [((e2 & 255) - 128) @ Q, ((e2 >> 8) - 128) @ Q, zero]
    elif q == "dhl":
        dlo, dhi = d & 255, d >> 8
        want += [(((dlo * dlo) & 255) - 128) @ Q, (((dlo * dlo) >> 8) - 128) @ Q,
                 (dhi * dlo - 128) @ Q + (dhi - 128) @ Q]
    else:
        want += [zero] * 3
    for g, w in zip(packed, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", profile_bgen.MODES)
def test_profile_bgen_script_runs_on_cpu(capsys, mode):
    """The port's profile script in each mode at a tiny shape on the CPU:
    its lines in the JAX script's names and order (the default mode: prod
    and each Hopper configuration of base-i32miss-3q), host times and no
    rates, and its check lines last, each 0; no launch."""
    n0 = {k: w.launches for k, w in kernels.WRAPPERS.items()}
    out = profile_bgen.main(mode, n=1000, p=3, k=2, b=16, rounds=1, blocks=2,
                            device="cpu")
    assert {k: w.launches for k, w in kernels.WRAPPERS.items()} == n0
    text = capsys.readouterr().out.splitlines()
    want = {"default": ["prod"] + [f"base-i32miss-3q ({c})"
                                   for c in kernels.PROFILE_BGEN_CONFIGS],
            "variants": ["base(=prod)", "no-q", "u8-xor-wdots"],
            "variants2": ["sep-planes", "sep-noq", "sep-merge2dot"],
            "variants3": ["base-i32miss-3q", "e2-2q", "dhl-2q+2tiny"]}[mode]
    assert [ln["name"] for ln in out["lines"]] == want
    assert text[0] == "device: cpu (plain versions)"
    assert [t[:50].strip() for t in text[2 : 2 + len(want)]] == want
    assert out["shape"] == dict(N=1000, P=3, K=2, B=16, Np=1024, Cw=512, Cq=512,
                                blocks=2, rounds=1)
    assert all(ln["ms"] > 0 and ln["tops"] is None for ln in out["lines"])
    assert out["checks"] == {name: 0 for name in want}
    assert text[-len(want):] == [f"{name} vs plain max|d|: 0" for name in want]


def test_profile_bgen_script_blocks():
    """The script's planes: k0 below 200, k0 + k1 <= 255 but on the
    sentinel, about 2% sentinel pairs in the default mode and none in the
    others, pad samples zero; the packed layout's k0, k1 are views of one
    [B, 2, Np] buffer."""
    for packed, miss in ((True, 0.02), (False, 0.0)):
        blk = profile_bgen.make_blocks(300, 1000, 1024, 1, packed, miss, "cpu")[0]
        k0, k1 = blk["k0"].long(), blk["k1"].long()
        sentinel = (k0 == 255) & (k1 == 255)
        assert (blk["planes"] is not None) == packed
        if packed:
            assert blk["k0"].data_ptr() == blk["planes"].data_ptr()
            assert blk["k1"].data_ptr() == blk["planes"].data_ptr() + 1024
        assert not k0[:, 1000:].any() and not k1[:, 1000:].any()
        assert k0[~sentinel].max() < 200 and (k0 + k1)[~sentinel].max() <= 255
        assert abs(float(sentinel[:, :1000].double().mean()) - miss) < 0.003


def test_profile_bgen_script_needs_a_card_unless_asked(monkeypatch):
    """With no CUDA device and no CPU request the script raises before it
    builds anything: it does not drop to the CPU; an unknown mode raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("REGENIE_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="found no CUDA device"):
        profile_bgen.main("variants", n=1000, p=3, k=2, b=16, rounds=1, blocks=1)
    with pytest.raises(ValueError, match="mode"):
        profile_bgen.main("variants4", device="cpu")


def _inputs(B=2, Np=16, Cw=16, Cq=16):
    planes = torch.zeros((B, 2, Np), dtype=torch.uint8)
    return (planes[:, 0], planes[:, 1], torch.zeros((Np, Cw), dtype=torch.int8),
            torch.zeros((Np, Cq), dtype=torch.int8))


@pytest.mark.parametrize("fault", ["device", "dtype", "shape", "stride", "np16"])
def test_profile_bgen_wrappers_reject_bad_inputs(fault):
    """Every profile_bgen wrapper raises, on any device, for tensors on two
    devices, planes that are not uint8 or limbs that are not int8, shapes
    that do not match, planes without a unit sample stride or one shared
    row stride (a multiple of 16), and Np, Cw or Cq not a multiple of 16;
    it does not move, cast, copy or fall back."""
    k0, k1, wp, wq = _inputs()
    for fn in kernels.PROFILE_BGEN.values():
        if fault == "device":
            with pytest.raises(ValueError, match="same CUDA device"):
                fn(k0, k1, wp.to("meta"), wq)
        elif fault == "dtype":
            for bad in ((k0.to(torch.int8), k1, wp, wq), (k0, k1, wp.to(torch.uint8), wq),
                        (k0, k1, wp, wq.float())):
                with pytest.raises(TypeError, match="torch.uint8"):
                    fn(*bad)
        elif fault == "shape":
            for bad in ((k0, k1[:1], wp, wq), (k0, k1, wp[:8], wq),
                        (k0[0], k1[0], wp, wq), (k0, k1, wp, wq[:, None])):
                with pytest.raises(ValueError, match=r"k0, k1 \[B, Np\]"):
                    fn(*bad)
        elif fault == "stride":
            wide = torch.zeros((2, 64), dtype=torch.uint8)
            for bad in ((wide[:, ::4], wide[:, 1::4], wp, wq),
                        (k0, k1.contiguous(), wp, wq),
                        (torch.zeros((2, 40), dtype=torch.uint8)[:, :16],
                         torch.zeros((2, 40), dtype=torch.uint8)[:, :16], wp, wq)):
                with pytest.raises(ValueError, match="stride"):
                    fn(*bad)
            with pytest.raises(ValueError, match="contiguous"):
                fn(k0, k1, torch.zeros((16, 32), dtype=torch.int8)[:, ::2], wq)
        else:
            for bad in (_inputs(Np=24), _inputs(Cw=24), _inputs(Cq=8)):
                with pytest.raises(ValueError, match="multiples of 16"):
                    fn(*bad)


def test_profile_bgen_wrappers_configs_and_names():
    """Only u8_unshift_q3 has several Hopper configurations; every wrapper
    takes configuration 0 and rejects one it does not have, on any device;
    every wrapper is in kernels.WRAPPERS under its kernel name."""
    x = _inputs()
    assert list(kernels.PROFILE_BGEN) == VARIANTS
    for v, fn in kernels.PROFILE_BGEN.items():
        n = len(kernels.PROFILE_BGEN_CONFIGS) if v == "u8_unshift_q3" else 1
        assert kernels.WRAPPERS[f"profile_bgen_{v}"] is fn
        assert fn.__name__ == f"profile_bgen_{v}_products"
        for c in range(n):
            outs = fn(*x, config=c)
            assert [tuple(o.shape) for o in outs] == [(2, 16)] * 6
        for bad in (-1, n):
            with pytest.raises(ValueError, match="config"):
                fn(*x, config=bad)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_CUDA_CASES = [(v, c) for v in VARIANTS
               for c in range(len(kernels.PROFILE_BGEN_CONFIGS)
                              if v == "u8_unshift_q3" else 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,config", _CUDA_CASES)
def test_profile_bgen_kernel_matches_plain_on_cuda(cuda, variant, config):
    """Each variant and configuration against its plain version on the
    card (float64 products, exact), exactly, on both layouts: ragged rows
    (B=77), Np a multiple of 16 but not of the 128-sample stage, Cw and Cq
    off the 128-column tile, every byte pair (about half missing); a
    one-row-tile case; Np = 70,016, past one int32 chunk; and zero planes
    against limbs of -128, whose int32 chunk sums reach 2^30 (dhl's q2
    twice the others' per sample). Each call counts one launch of its own
    wrapper."""
    rng = np.random.default_rng(17)
    fn = kernels.PROFILE_BGEN[variant]
    name = f"profile_bgen_{variant}"
    for B, Np, Cw, Cq, extreme in ((77, 272, 400, 144, False), (5, 16, 16, 16, False),
                                   (130, 70016, 160, 48, False),
                                   (33, 70016, 144, 144, True)):
        if extreme:
            planes = torch.zeros((B, 2, Np), dtype=torch.uint8, device=cuda)
            wp = torch.full((Np, Cw), -128, dtype=torch.int8, device=cuda)
            wq = torch.full((Np, Cq), -128, dtype=torch.int8, device=cuda)
        else:
            planes = torch.from_numpy(
                rng.integers(0, 256, (B, 2, Np), dtype=np.uint8)).to(cuda)
            wp, wq = (torch.from_numpy(rng.integers(-128, 128, (Np, c), dtype=np.int8)).to(cuda)
                      for c in (Cw, Cq))
        want = kernels.profile_bgen_products_plain(planes[:, 0], planes[:, 1], wp, wq,
                                                   variant)
        for k0, k1 in ((planes[:, 0], planes[:, 1]),
                       (planes[:, 0].contiguous(), planes[:, 1].contiguous())):
            n0 = {k: w.launches for k, w in kernels.WRAPPERS.items()}
            got = fn(k0, k1, wp, wq, config=config)
            n1 = {k: w.launches for k, w in kernels.WRAPPERS.items()}
            assert n1 == {k: v + (k == name) for k, v in n0.items()}
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == torch.int64 and torch.equal(g, w)
