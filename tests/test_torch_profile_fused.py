"""Tests of the port's fused-BED profiling entry point
(regenie_tpu_torch.scripts.profile_fused) and its five kernel
configurations (ops/csrc/profile_fused.cu): on the CPU, each
configuration's plain version against the JAX package's own profiling
kernels of scripts/profile_fused.py, run unchanged in Pallas interpret
mode, on the same operand bits; the port's script end to end at a tiny
shape; the wrappers' input checks; and, with marker `cuda`, the kernels
against their plain versions. On the GPU machine, which has no JAX, run
the card's tests with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_profile_fused.py
"""

import functools
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from regenie_tpu_torch.ops import fused_score as tfs
from regenie_tpu_torch.ops import kernels
from regenie_tpu_torch.scripts import profile_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["stacked", "stacked-2dots", "nodecode", "decode-only", "pipelined"]


@pytest.fixture(scope="module")
def tpu_script():
    """scripts/profile_fused.py loaded unchanged, with its `pl` swapped for
    a copy of jax.experimental.pallas whose pallas_call runs in interpret
    mode (tests that take it skip where JAX is not installed)."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as jpl

    spec = importlib.util.spec_from_file_location(
        "tpu_profile_fused", os.path.join(REPO, "scripts", "profile_fused.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pl = types.SimpleNamespace(**{k: getattr(jpl, k) for k in dir(jpl)
                                  if not k.startswith("__")})
    pl.pallas_call = functools.partial(jpl.pallas_call, interpret=True)
    mod.pl = pl
    return mod


@pytest.fixture(scope="module")
def case():
    """The JAX package's bf16 split operand at N=700 (nbp = 256), P=3 (one
    incomplete trait), K=2, and B=16 rows of random bytes padded to nbp;
    the port's operand carries the same bits across."""
    pytest.importorskip("jax")
    from regenie_tpu.ops import fused_score as jfs

    rng = np.random.default_rng(5)
    N, P, K, B = 700, 3, 2, 16
    res = rng.normal(size=(N, P))
    maskf = np.ones((N, P))
    maskf[rng.random(N) < 0.05, 0] = 0.0
    cov = np.linalg.qr(rng.normal(size=(N, K)))[0]
    jc = jfs.build_consts(cov, res * maskf, maskf, np.ones(N, bool), float(N - K),
                          split=True)
    rawp = jfs.pad_raw(rng.integers(0, 256, size=(B, (N + 3) // 4), dtype=np.uint8))
    wp = tfs.consts_from_numpy(
        Wp=np.asarray(jc.Wp), usum=np.asarray(jc.usum),
        covt_res=np.asarray(jc.covt_res), Mmat=np.asarray(jc.Mmat),
        n_ind=jc.n_ind, K=jc.K, P=jc.P, scale_denom=jc.scale_denom).Wp
    assert rawp.shape == (B, 256) and wp.shape == (4, 256, 384)
    return rawp, jc.Wp, torch.from_numpy(rawp), wp


def _port(config, raw, wp):
    """The port's wrapper of a configuration (its plain version on CPU
    tensors) and the plain version against |wp| (the bar's product)."""
    fn, bar_fn = {
        "stacked": (kernels.profile_stacked_products,
                    kernels.profile_stacked_products_plain),
        "stacked-2dots": (kernels.profile_stacked_2dots_products,
                          kernels.profile_stacked_products_plain),
        "nodecode": (kernels.profile_nodecode_products,
                     kernels.profile_nodecode_products_plain),
        "decode-only": (kernels.profile_decode_only_products, None),
        "pipelined": (kernels.profile_pipelined_products,
                      kernels.profile_pipelined_products_plain),
    }[config]
    return fn(raw, wp), None if bar_fn is None else bar_fn(raw, wp.abs())


@pytest.mark.parametrize("config", CONFIGS)
def test_profile_plain_matches_tpu_script_kernel(tpu_script, case, config):
    """Each configuration's plain version (through its wrapper on CPU
    tensors: no launch) against the JAX script's kernel in interpret mode,
    run_variant / run_pipelined with tb=8, tc=128, on the same bits, with
    64-bit types off as in the script's own runs: within 4*nbp*2^-24 of the
    product against |wp|, since JAX sums in float32; decode-only exactly,
    and M of stacked-2dots 0 on both sides. The TPU decode-only kernel
    sums a tile's indicators in bf16, exact only up to 256, and the pad
    bytes (code 0) push a 128-byte tile's H count past that: it runs with
    tc=64 (256 indicators a tile)."""
    import jax
    import jax.numpy as jnp

    rawp, jWp, raw, wp = case
    m = tpu_script
    r = jnp.asarray(rawp)
    with jax.enable_x64(False):
        if config == "pipelined":
            want = m.run_pipelined(r, jWp, 8, 128)
        else:
            kern = {"stacked": m._stacked_kernel, "stacked-2dots": m._stacked_kernel,
                    "nodecode": m._nodecode_kernel,
                    "decode-only": m._decode_only_kernel}[config]
            kw = (("with_m", False),) if config == "stacked-2dots" else ()
            want = m.run_variant(r, jWp, kern, 8,
                                 64 if config == "decode-only" else 128, kw)
    n0 = {k: w.launches for k, w in kernels.WRAPPERS.items()}
    got, bar = _port(config, raw, wp)
    assert {k: w.launches for k, w in kernels.WRAPPERS.items()} == n0
    rel = 4 * raw.shape[1] * 2.0**-24
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float64 and g.shape == (16, 384)
        w = np.asarray(w, np.float64)
        if config == "decode-only":
            np.testing.assert_array_equal(g.numpy(), w)
            assert g[:, 0].sum() > 0 and not g[:, 1:].any()
        elif config == "stacked-2dots" and i == 2:
            assert not g.any() and not w.any()
        else:
            assert np.all(np.abs(g.numpy() - w) <= rel * bar[i].numpy())
            assert np.abs(w).max() > 1.0


@pytest.mark.parametrize("how", ["arguments", "environment"])
def test_profile_script_runs_on_cpu(monkeypatch, capsys, how):
    """The port's profile script at a tiny shape on the CPU, its knobs given
    as arguments or as BENCH_* variables (with BENCH_SWEEP): the lines in
    the script's order, host times and no rates, and its two correctness
    lines within 4*nbp*2^-24 relative to the |wp| products; no launch."""
    knobs = dict(n=700, p=3, k=2, b=16, rounds=1, blocks=2)
    n0 = {k: w.launches for k, w in kernels.WRAPPERS.items()}
    if how == "arguments":
        out = profile_fused.main(**knobs, sweep=False, device="cpu")
    else:
        for key, v in knobs.items():
            monkeypatch.setenv(f"BENCH_{key.upper()}", str(v))
        monkeypatch.setenv("BENCH_SWEEP", "1")
        monkeypatch.setenv("REGENIE_TPU_TORCH_DEVICE", "cpu")
        out = profile_fused.main()
    assert {k: w.launches for k, w in kernels.WRAPPERS.items()} == n0
    text = capsys.readouterr().out.splitlines()
    names = [ln["name"] for ln in out["lines"]]
    want = ["prod", "stacked (64x64 tile, 3 stages)", "nodecode", "stacked-2dots",
            "decode-only", "pipelined (4 decode warps, 4 stages)",
            "pipelined (2 decode warps, 4 stages)"]
    if how == "environment":
        want += ["stacked (64x64 tile, 4 stages)", "stacked (64x64 tile, 2 stages)"]
    assert names == want
    assert text[0] == "device: cpu (plain versions)"
    assert [t.split("  ")[0].strip() for t in text[2 : 2 + len(want)]] == want
    assert out["shape"]["nbp"] == 256 and out["shape"]["Cw"] == 384
    assert all(ln["ms"] > 0 and ln["tflops"] is None for ln in out["lines"])
    bar = 4 * 256 * 2.0**-24
    assert len(text) == 2 + len(want) + 6
    for name in ("pipelined", "stacked"):
        for nm in ("S1", "SQ", "SM"):
            d, rel = out["checks"][name][nm]
            assert rel <= bar and d <= bar
            assert any(t.startswith(f"{name} vs prod max|d| {nm}:") for t in text[-6:])


def test_profile_script_needs_a_card_unless_asked(monkeypatch):
    """With no CUDA device and no CPU request the script raises before it
    builds anything: it does not drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("REGENIE_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="found no CUDA device"):
        profile_fused.main(n=700, p=3, k=2, b=16, rounds=1, blocks=1)


_WRAPPERS = {
    "stacked": kernels.profile_stacked_products,
    "stacked-2dots": kernels.profile_stacked_2dots_products,
    "nodecode": kernels.profile_nodecode_products,
    "decode-only": kernels.profile_decode_only_products,
    "pipelined": kernels.profile_pipelined_products,
}


@pytest.mark.parametrize("fault", ["device", "dtype", "shape"])
@pytest.mark.parametrize("config", CONFIGS)
def test_profile_wrappers_reject_bad_inputs(config, fault):
    """A wrapper given tensors on two devices, an operand that is not
    bfloat16 or raw that is not uint8, or shapes that do not match raises;
    it does not move, cast or fall back."""
    fn = _WRAPPERS[config]
    raw = torch.zeros((2, 16), dtype=torch.uint8)
    wp = torch.zeros((4, 16, 8), dtype=torch.bfloat16)
    if fault == "device":
        with pytest.raises(ValueError, match="same CUDA device"):
            fn(raw, wp.to("meta"))
    elif fault == "dtype":
        with pytest.raises(TypeError, match="torch.bfloat16"):
            fn(raw, wp.float())
        with pytest.raises(TypeError, match="torch.uint8"):
            fn(raw.to(torch.int16), wp)
    else:
        for r, w in ((raw, wp[:3]), (raw, wp[:, :8]), (raw[0], wp)):
            with pytest.raises(ValueError, match=r"raw \[B, nbp\] and wp"):
                fn(r, w)


@pytest.mark.parametrize("fn,n", [(kernels.profile_stacked_products,
                                   len(kernels.PROFILE_STACKED_CONFIGS)),
                                  (kernels.profile_pipelined_products,
                                   len(kernels.PROFILE_PIPELINED_CONFIGS))])
def test_profile_wrappers_reject_unknown_config(fn, n):
    """The stacked and pipelined wrappers take a configuration index below
    the number of their Hopper configurations, on any device."""
    raw = torch.zeros((2, 16), dtype=torch.uint8)
    wp = torch.zeros((4, 16, 8), dtype=torch.bfloat16)
    assert fn(raw, wp, config=n - 1)[0].shape == (2, 8)
    for bad in (-1, n):
        with pytest.raises(ValueError, match="config"):
            fn(raw, wp, config=bad)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_CUDA_CASES = ([("stacked", c) for c in range(len(kernels.PROFILE_STACKED_CONFIGS))]
               + [("stacked-2dots", 0), ("nodecode", 0), ("decode-only", 0)]
               + [("pipelined", c)
                  for c in range(len(kernels.PROFILE_PIPELINED_CONFIGS))])


@pytest.mark.cuda
@pytest.mark.parametrize("config,index", _CUDA_CASES)
def test_profile_kernel_matches_plain_on_cuda(cuda, config, index):
    """Each kernel configuration against its plain version on the card, on
    ragged shapes (rows off the row tile, bytes ending mid-stage, columns
    off the column tile) and a contraction of several flushes: decode-only
    exactly, the others within BF16_FLUSH x 2^-23 of the product against
    |wp|; each call counts one launch of its own wrapper."""
    rng = np.random.default_rng(13)
    fn = _WRAPPERS[config]
    name = {"stacked": "profile_stacked", "stacked-2dots": "profile_stacked_2dots",
            "nodecode": "profile_nodecode", "decode-only": "profile_decode_only",
            "pipelined": "profile_pipelined"}[config]
    kw = {"config": index} if config in ("stacked", "pipelined") else {}
    rel = kernels.BF16_FLUSH * 2.0**-23
    for B, nbp, Cw in ((37, 272, 400), (130, 2064, 1152), (5, 16, 24)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nbp), dtype=np.uint8)).to(cuda)
        wp = torch.from_numpy(rng.normal(size=(4, nbp, Cw)).astype(np.float32)).to(
            cuda).to(torch.bfloat16)
        n0 = {k: w.launches for k, w in kernels.WRAPPERS.items()}
        got = fn(raw, wp, **kw)
        n1 = {k: w.launches for k, w in kernels.WRAPPERS.items()}
        assert n1 == {k: v + (k == name) for k, v in n0.items()}
        want, bar = _port(config, raw.cpu(), wp.cpu())
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.float64 and g.shape == (B, Cw)
            g = g.cpu()
            if bar is None:
                assert torch.equal(g, w)
            else:
                assert torch.all((g - w).abs() <= rel * bar[i])
