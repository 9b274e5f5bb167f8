"""Device and dtype policy of the port (its counterpart of
regenie_tpu/utils/dtypes.py).

- Entry points run on CUDA. The CPU is used only when the caller asks
  for it: device="cpu" in Python, or REGENIE_TPU_TORCH_DEVICE=cpu for
  the CLI (the counterpart of REGENIE_TPU_PLATFORM=cpu).
- With no CUDA device and no such request, resolve_device raises: an
  entry point never carries on on the CPU by itself.
- On CUDA, TF32 is switched off for matmuls and convolutions (the
  reference's dots run at Precision.HIGHEST).
- The working dtype is float64 on both devices. On the card the int8
  kernels' integer products fold exactly into float64 and the epilogue
  runs there: in float32, the incomplete-trait denominators cancel
  enough at biobank N (400,000 samples) to move LOG10P by more than the
  1e-5 cross-backend bar against the float64 reference, and the
  epilogue is a few [B, C] operations, so float64 costs nothing there.
- REGENIE_TPU_I8=0 selects, as in the JAX package, the float32 operand
  on the card; the constants (usum, covt_res, Mmat) stay float64. Its
  kernels take the float32 values and form exact products (an indicator
  or a byte times an f32 value) summed in float64 on the FP64 tensor
  cores, for the same reason: a float32 sum over 400,000 samples would
  carry ~1e-5 relative error into the same cancelling denominators.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "REGENIE_TPU_TORCH_DEVICE"


def requested_device(device=None) -> torch.device:
    """The device an entry point is asked to run on: `device` if given,
    else $REGENIE_TPU_TORCH_DEVICE, else CUDA (not checked)."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    return torch.device(device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on (requested_device). Raises when
    CUDA is asked for (explicitly or by default) and there is none."""
    dev = requested_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "regenie_tpu_torch runs on CUDA and found no CUDA device; "
                f"pass device='cpu' or set {DEVICE_ENV}=cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev

