"""Multi-process runtime of the port (the counterpart of
regenie_tpu/parallel/dist.py, on torch.distributed).

Every process of a launch runs the SAME CLI invocation; the processes'
shards form one global mesh (parallel/mesh.py), the results come back in
process order, and only the output host (process 0) writes files. It
replaces regenie's multi-machine story: the split-l0 shared-filesystem
jobs and the per-chromosome Step-2 jobs.

Activation (before any device work):
- REGENIE_TPU_COORDINATOR=host:port with REGENIE_TPU_NUM_PROCESSES=n and
  REGENIE_TPU_PROCESS_ID=i: a TCP rendezvous at host:port.
- REGENIE_TPU_DIST=1: the environment that torchrun sets (MASTER_ADDR,
  MASTER_PORT, RANK, WORLD_SIZE).

The collectives run on gloo over host tensors: the products stay on each
process's cards and only their partials and result rows cross between
processes. The sums across processes are not all_reduce (whose order is
the backend's): every partial is gathered and the sum is taken in global
shard order (parallel.mesh.psum), so a run of P processes x S shards
gives the bytes of one process with P*S shards on the same device type.
A finite timeout (REGENIE_TPU_DIST_TIMEOUT seconds, default 900) makes a
process whose peer died fail instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

COORD_ENV = "REGENIE_TPU_COORDINATOR"
DIST_ENV = "REGENIE_TPU_DIST"
NPROC_ENV = "REGENIE_TPU_NUM_PROCESSES"
PID_ENV = "REGENIE_TPU_PROCESS_ID"
TIMEOUT_ENV = "REGENIE_TPU_DIST_TIMEOUT"

def maybe_init_distributed(log=print) -> bool:
    """Join the launch's process group from the environment (idempotent;
    before any device work). Returns True when the run is multi-process.
    Raises when the group cannot be formed within the timeout."""
    coord = os.environ.get(COORD_ENV)
    if not dist.is_initialized() and (coord or os.environ.get(DIST_ENV)):
        timeout = datetime.timedelta(seconds=float(os.environ.get(TIMEOUT_ENV, "900")))
        if coord:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coord}",
                world_size=int(os.environ[NPROC_ENV]),
                rank=int(os.environ[PID_ENV]), timeout=timeout)
        else:
            dist.init_process_group("gloo", init_method="env://", timeout=timeout)
        log(f" * distributed: process {process_index()} of {process_count()} "
            f"(gloo, {coord or 'env://'})")
    return process_count() > 1


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_output_host() -> bool:
    """Only process 0 writes files: every process holds the same gathered
    results, and process 0 renders them."""
    return process_index() == 0


class _NullSink:
    """A text or binary sink that discards what is written (the writers of
    the processes other than the output host)."""

    closed = False

    def write(self, s):
        return len(s)

    def tell(self) -> int:
        return 0

    def flush(self):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def allgather_py(obj) -> list:
    """One picklable object a process, in process order (the transport of
    the ordered output merge). Single-process: [obj]."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def allgather_tensor(t: torch.Tensor, dst: Optional[int] = None):
    """Every process's tensor t (each of one shape and dtype), on the host
    in process order; with dst only process dst receives them (every
    other process gets None). Raises in every process when the shapes or
    dtypes differ."""
    t = t.detach().cpu().contiguous()
    if process_count() == 1:
        return [t]
    metas = allgather_py((tuple(t.shape), str(t.dtype)))
    if any(m != metas[0] for m in metas):
        raise ValueError(f"allgather_tensor: the processes' tensors differ: {metas}")
    wire = t.view(torch.uint8) if t.dtype == torch.bool else t
    out = [torch.empty_like(wire) for _ in range(process_count())]
    if dst is None:
        dist.all_gather(out, wire)
    else:
        out = out if process_index() == dst else None
        dist.gather(wire, out, dst=dst)
        if out is None:
            return None
    return [o.view(torch.bool) for o in out] if t.dtype == torch.bool else out
