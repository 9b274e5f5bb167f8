"""Single-process device mesh (the port's counterpart of the 1-D parts of
regenie_tpu/parallel/mesh.py): one process drives every card it sees.

- Step 1 shards the SAMPLE axis: each shard forms its partial Gram
  matrices G G' and G'Y, their sum (psum) is taken on the first shard's
  device, the B x B eigendecomposition runs there once, and each shard
  predicts its own samples, with the centring moments summed the same way.
- Step 2 shards the VARIANT axis: each shard scores its rows against the
  replicated operand, with no reduction; the rows come back in order.

A mesh is an ordered tuple of torch.device, one per shard. Several shards
may share a device (REGENIE_TPU_TORCH_MESH_DEVICES=cuda:0,cuda:0): a
replicated operand is then one tensor for all of them, and the sums run in
shard order whatever the transport, so the results do not depend on how
the shards map onto cards.

No function here synchronizes the host with a device between one shard's
work and the next: every shard's kernels are queued before anything waits
on a result (an eigendecomposition, a copy to the host), so shards on
distinct cards run at once. Copies between cards (replicate, gather, psum)
are device-to-device copies, ordered by the streams, not by the host.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

MESH_ENV = "REGENIE_TPU_MESH"
DEVICES_ENV = "REGENIE_TPU_TORCH_MESH_DEVICES"

Mesh = Tuple[torch.device, ...]


class Sharded(NamedTuple):
    """A row-sharded block: its per-shard parts (rows zero-padded to a
    multiple of the shard count, part i on shard i's device) and its row
    count before the padding."""

    parts: List[torch.Tensor]
    n: int


def _device(d) -> torch.device:
    """A torch.device with the CUDA index made explicit (so that 'cuda'
    and 'cuda:0' name one device); raises on a card that is not there."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d}: no CUDA device")
        idx = torch.cuda.current_device() if d.index is None else d.index
        if idx >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device cuda:{idx}: only "
                               f"{torch.cuda.device_count()} CUDA devices")
        return torch.device("cuda", idx)
    if d.type != "cpu":
        raise ValueError(f"unsupported mesh device {d} (cuda or cpu)")
    return d


def make_mesh(devices=None) -> Mesh:
    """A mesh of `devices` (names or torch.device, in shard order), by
    default every visible card in index order."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(_device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: no devices")
    return mesh


def maybe_mesh(device) -> Optional[Mesh]:
    """The mesh of a run on `device`, or None for a single-device run
    (regenie_tpu/parallel/mesh.py:148-161): on the card, every visible
    card when there are several, or the shards that
    REGENIE_TPU_TORCH_MESH_DEVICES lists; on the CPU, the listed shards,
    and only under REGENIE_TPU_MESH. A mesh of one shard is None. Raises
    when a listed device is not of the run's device type."""
    device = torch.device(device)
    listed = os.environ.get(DEVICES_ENV, "").strip()
    if listed:
        devs = [torch.device(d.strip()) for d in listed.split(",") if d.strip()]
        bad = [str(d) for d in devs if d.type != device.type]
        if bad:
            raise ValueError(f"{DEVICES_ENV} lists {', '.join(bad)} for a run "
                             f"on {device.type}")
        if device.type == "cpu" and not os.environ.get(MESH_ENV):
            return None
        mesh = make_mesh(devs)
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = make_mesh()
    else:
        return None
    return mesh if len(mesh) > 1 else None


def run_mesh(params, device) -> Optional[Mesh]:
    """The mesh of a run on `device` (maybe_mesh), or None where the run
    takes none, as in the JAX package: Step 1 with --print or --test-l0
    (regenie_tpu/run_step1.py:250-345), Step 2 under --strict or on a
    trait type other than QT, BT, CT and T2E
    (regenie_tpu/run_step2.py:313-322). The one rule that cli.unported,
    run_step1.open_step1 and run_step2.Step2Engine read."""
    from ..config import BT, CT, QT, T2E

    if params.step == 1:
        takes = not (params.print_block_betas or params.test_l0)
    else:
        takes = params.trait_mode in (QT, BT, CT, T2E) and not params.strict_mode
    return maybe_mesh(device) if takes else None


def pad_to(x, mult: int, axis: int):
    """Zero-pad an axis of a numpy array or a tensor up to a multiple of
    mult. Returns (padded, the axis' length before)."""
    n = x.shape[axis]
    rem = (-n) % mult
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = rem
    if isinstance(x, torch.Tensor):
        z = torch.zeros(shape, dtype=x.dtype, device=x.device)
        return torch.cat([x, z], dim=axis), n
    return np.concatenate([x, np.zeros(shape, x.dtype)], axis=axis), n


def _to(x, dev: torch.device):
    """x on dev: a tensor (no copy when it is there already), a numpy
    array, a NamedTuple, list or tuple of those (field by field);
    anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def replicate(mesh: Mesh, x) -> list:
    """x on every shard's device, one entry a shard; shards that share a
    device share one copy (the same object), and a tensor already on a
    shard's device is that tensor."""
    copies = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = _to(x, dev)
    return [copies[dev] for dev in mesh]


def shard(mesh: Mesh, x, axis: int = 0) -> List[torch.Tensor]:
    """x (a tensor or numpy array) split along `axis` into one contiguous
    part a shard, on that shard's device, the axis zero-padded first to a
    multiple of the shard count."""
    xp, _ = pad_to(x, len(mesh), axis)
    if isinstance(xp, np.ndarray):
        xp = torch.from_numpy(xp)
    return [p.contiguous().to(dev) if p.device != dev or not p.is_contiguous()
            else p for p, dev in zip(torch.chunk(xp, len(mesh), dim=axis), mesh)]


def shard_rows(mesh: Mesh, x) -> Sharded:
    """shard along the leading (row) axis, with the row count kept."""
    return Sharded(shard(mesh, x, 0), int(x.shape[0]))


def gather(parts, axis: int = 0, n: Optional[int] = None) -> torch.Tensor:
    """The per-shard parts concatenated along `axis` in shard order on the
    first shard's device, cut to n entries along the axis when given."""
    dev = parts[0].device
    out = torch.cat([p.to(dev) for p in parts], dim=axis)
    return out if n is None else out.narrow(axis, 0, n)


def psum(parts) -> torch.Tensor:
    """The sum of the per-shard partials, each copied to the first
    shard's device and added in shard order."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _parts(mesh: Mesh, x, axis: int) -> List[torch.Tensor]:
    """The per-shard parts of a sharded argument: a list of parts as it
    is, a Sharded's parts, or a whole tensor / array sharded along axis."""
    if isinstance(x, Sharded):
        return x.parts
    if isinstance(x, list):
        if len(x) != len(mesh):
            raise ValueError(f"{len(x)} parts for a mesh of {len(mesh)} shards")
        return x
    return shard(mesh, x, axis)


def _reps(mesh: Mesh, x) -> list:
    """The per-shard copies of a replicated argument: a list of copies as
    it is (replicate's result, kept by a caller across blocks), else x
    replicated."""
    if isinstance(x, list):
        if len(x) != len(mesh):
            raise ValueError(f"{len(x)} copies for a mesh of {len(mesh)} shards")
        return x
    return replicate(mesh, x)


# ---- Step 1: sample-sharded Grams and level 0 ----


def sharded_gram(mesh: Mesh, G, Y):
    """Sample-sharded Gram matrices of Step-1 level 0 (calc_cv_matrices,
    Data.cpp:729): G [B, N] sharded over N, Y [N, P] sharded over N.
    Returns (G G' [B, B], G'Y [B, P]) on the first shard's device."""
    Gs, Ys = _parts(mesh, G, 1), _parts(mesh, Y, 0)
    return (psum([g @ g.T for g in Gs]),
            psum([g @ y for g, y in zip(Gs, Ys)]))


def sharded_level0_loocv(mesh: Mesh, G, Y, maskf, lambdas, Neff):
    """Sample-sharded Step-1 level-0 LOOCV ridge (the mesh form of
    models/step1.level0_loocv_block): the Gram partials summed, ONE B x B
    eigendecomposition on the first shard's device, each shard's
    leave-one-out predictions, and their centring and scaling moments
    summed.

    G: [B, N] sharded over N; Y, maskf: [N, P] sharded over N (samples
    past the true N zero, with maskf 0); lambdas [J], Neff [P]. Returns
    W [Npad, J, P] on the first shard's device (the caller cuts the pad
    rows)."""
    Gs, Ys, Ms = _parts(mesh, G, 1), _parts(mesh, Y, 0), _parts(mesh, maskf, 0)
    GGt = psum([g @ g.T for g in Gs])
    GTY = psum([g @ y for g, y in zip(Gs, Ys)])
    dev = GGt.device
    lam = torch.as_tensor(lambdas, dtype=GGt.dtype, device=dev)
    d, V = torch.linalg.eigh(GGt)
    Vt = V.T
    Wmat = Vt @ GTY  # [B, P]
    DL_inv = 1.0 / (d[:, None] + lam[None, :])  # [B, J]
    B, J, P = Vt.shape[0], lam.shape[0], Wmat.shape[1]
    # z2t[n, j, p] = sum_b VtG[b, n] DL_inv[b, j] Wmat[b, p]
    DW = (DL_inv[..., None] * Wmat[:, None, :]).reshape(B, J * P)
    ops = replicate(mesh, (Vt, DL_inv, DW))
    preds = []
    for g, y, m, (Vt_s, DL_s, DW_s) in zip(Gs, Ys, Ms, ops):
        VtG = Vt_s @ g  # [B, n_loc]
        gvec = (VtG * VtG).T @ DL_s  # [n_loc, J]
        z2t = (VtG.T @ DW_s).view(-1, J, P)
        pred = (z2t - gvec[..., None] * y[:, None, :]) / (1.0 - gvec)[..., None]
        preds.append(pred * m[:, None, :])
    neff = torch.as_tensor(Neff, dtype=GGt.dtype, device=dev)
    p_mean = psum([p.sum(dim=0) for p in preds]) / neff  # [J, P]
    pm_s = replicate(mesh, p_mean)
    preds = [(p - mu) * m[:, None, :] for p, mu, m in zip(preds, pm_s, Ms)]
    s2 = psum([(p * p).sum(dim=0) for p in preds])
    p_sd = torch.sqrt(s2 / (neff - 1.0))
    sd_s = replicate(mesh, p_sd)
    return gather([p / sd for p, sd in zip(preds, sd_s)], 0)


def sharded_level0_kfold(mesh: Mesh, G_folds, Y_folds, mask_folds, valid,
                         lambdas, Neff):
    """Sample-sharded Step-1 level-0 K-fold ridge (the mesh form of
    models/step1.level0_kfold_block; ridge_level_0,
    Step1_Models.cpp:458-560): the fold Gram partials summed, the K
    leave-fold-out eigendecompositions on the first shard's device, each
    shard's out-of-fold predictions, and their moments summed.

    G_folds: [K, B, nmax] sharded over nmax; Y_folds, mask_folds: [K,
    nmax, P] sharded over nmax; valid: [K, nmax] sharded over nmax (pad
    slots 0); lambdas [J], Neff [P]. Returns W [K, nmax_pad, J, P] on the
    first shard's device."""
    from ..models import step1 as m1

    Gs = _parts(mesh, G_folds, 2)
    Ys, Ms = _parts(mesh, Y_folds, 1), _parts(mesh, mask_folds, 1)
    Vs = _parts(mesh, valid, 1)
    Gvs = [g * v[:, None, :] for g, v in zip(Gs, Vs)]
    GGt_f = psum([g @ g.transpose(1, 2) for g in Gvs])
    GtY_f = psum([g @ y for g, y in zip(Gvs, Ys)])
    dev = GGt_f.device
    lam = torch.as_tensor(lambdas, dtype=GGt_f.dtype, device=dev)
    d, V = m1.kfold_eigh(GGt_f)
    beta = m1.kfold_beta(d, V, GtY_f, lam)  # [K, J, B, P]
    K, J, B, P = beta.shape
    bflat = replicate(mesh, beta.permute(0, 2, 1, 3).reshape(K, B, J * P))
    preds = [(g.transpose(1, 2) @ b).view(K, -1, J, P) * m[:, :, None, :]
             for g, b, m in zip(Gvs, bflat, Ms)]
    neff = torch.as_tensor(Neff, dtype=GGt_f.dtype, device=dev)[None, :]
    p_sum = psum([p.sum(dim=(0, 1)) for p in preds])  # [J, P]
    p_sum2 = psum([(p * p).sum(dim=(0, 1)) for p in preds])
    p_mean = p_sum / neff
    p_invsd = torch.sqrt((neff - 1.0) / (p_sum2 - neff * p_mean**2))
    ms = replicate(mesh, (p_mean, p_invsd))
    return gather([(p - mu) * s for p, (mu, s) in zip(preds, ms)], 1)


# ---- Step 2: variant-sharded scorers (no reductions) ----


def map_rows(mesh: Mesh, fn, G, *ops) -> tuple:
    """A row-independent block function on a mesh: fn(G's rows of a shard,
    *that shard's copies of ops) on every shard, all queued before any
    output is read, and each output's rows gathered in shard order on the
    first shard's device with the pad rows cut. G: a [B, ...] tensor or
    array (its rows zero-padded to the shard count and split), a Sharded
    or a list of parts; each of ops replicated (a list of per-shard
    copies, as replicate or Replicas give it, is taken as it is)."""
    Gs = _parts(mesh, G, 0)
    n = G.n if isinstance(G, Sharded) else (None if isinstance(G, list)
                                            else int(G.shape[0]))
    reps = [_reps(mesh, x) for x in ops]
    outs = [fn(g, *(r[i] for r in reps)) for i, g in enumerate(Gs)]
    return tuple(gather([o[k] for o in outs], 0, n) for k in range(len(outs[0])))


class Replicas:
    """The per-shard copies of a run's replicated operands, kept across
    blocks (the one cache of them): self(key, *xs) is [replicate(mesh, x)
    for x in xs], made again only when a source is not the object it was
    the last time under key, so an operand that changes once a chromosome
    is copied to the other cards once a chromosome. Shards that share a
    device share one copy, and the shards on a source's own device take
    the source itself."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._kept = {}

    def __call__(self, key, *xs) -> list:
        kept = self._kept.get(key)
        if kept is None or any(a is not b for a, b in zip(kept[0], xs)):
            kept = self._kept[key] = (xs, [replicate(self.mesh, x) for x in xs])
        return kept[1]


def sharded_score_qt(mesh: Mesh, G, res, maskf, cov, scale_denom):
    """Variant-sharded Step-2 QT score test: G [B, N] sharded over B;
    res, maskf, cov replicated. Each shard runs the single-device
    models/step2.residualize_scale_block and score_qt_block on its rows.
    Returns (stats [B, P], denum [B, P], scale_fac [B]) on the first
    shard's device. Rows whose scale_fac is below 1e-8 are left unscaled,
    where the JAX package's twin leaves those below 1e-12; such rows are
    low-variance, and Step 2 drops them either way."""
    from ..models import step2 as m2

    def score(g, r, m, c):
        Gr, sf, _ = m2.residualize_scale_block(g, c, scale_denom)
        return (*m2.score_qt_block(Gr, r, m, scale_denom, False), sf)

    return map_rows(mesh, score, G, res, maskf, cov)


def sharded_score_bt(mesh: Mesh, G, Wcat, xwt, gsm2, Pn: int, Kp1: int):
    """Variant-sharded all-trait BT score products (compute_score_bt,
    Step2_Models.cpp:470-520): models/step2_bt._allpass on each shard's
    rows of G [B, N]; Wcat [N, Pn*Kp1], xwt [Pn, Kp1-1] and gsm2 [N, Pn]
    replicated. Returns (num [B, Pn], denum [B, Pn], S1 [B, Pn, Kp1]) on
    the first shard's device."""
    from ..models import step2_bt

    return map_rows(mesh, lambda g, W, x, g2: step2_bt._allpass(g, W, x, g2, Pn, Kp1),
                    G, Wcat, xwt, gsm2)


def sharded_score_t2e(mesh: Mesh, G, WX1, Xinv_t, resmask):
    """Variant-sharded Cox score products (compute_score_cox,
    Step2_Models.cpp:632): models/step2_t2e.cox_products on each shard's
    rows of G [B, N]; WX1 [N, q], Xinv_t [q, N] and resmask [N, 1]
    replicated. Returns (T [B], denum_raw [B]) on the first shard's
    device."""
    from ..models import step2_t2e

    return map_rows(mesh, lambda g, W, Xi, rm: step2_t2e.cox_products(
        g, W, Xi.T, rm[:, 0])[1:], G, WX1, Xinv_t, resmask)
