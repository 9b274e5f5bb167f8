"""regenie_tpu_torch — the PyTorch/CUDA port of regenie_tpu.

A second package beside the JAX reference (regenie_tpu/), written for one
NVIDIA H100. It imports torch, numpy and scipy, never jax, and nothing
from regenie_tpu: where it needs a host module it keeps its own copy.
Every Pallas kernel of the reference becomes a hand-written Hopper
kernel (ops/kernels.py, sources under ops/csrc/); plain tensor code is
PyTorch. Entry points run on CUDA; the CPU is used only when the caller
asks for it (device="cpu", or REGENIE_TPU_TORCH_DEVICE=cpu for the CLI).

Ported so far: Step 2 on quantitative traits through the fused scorer,
from PLINK BED hardcalls and from BGEN v1.2 8-bit (zlib) dosages. Every
other mode raises NotImplementedError.
"""

__version__ = "0.1.0"
