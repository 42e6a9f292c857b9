"""Groups of ranks over ``torch.distributed``, and the launcher that starts
them.

The JAX package runs one program over a device mesh (``jax.sharding``);
the port runs one process per rank, as FEMuS runs one MPI rank per
subdomain.  A rank sees its group through :class:`RankGroup` (world size,
rank, device, backend) and talks through its collectives; the reductions
the solvers need (:meth:`RankGroup.sum`) are explicit.

Backend rule (:func:`choose_backend`, printed by :func:`launch`):

- ``nccl`` when every rank has a card of its own;
- ``gloo`` when ranks share a card or run on the CPU.  NCCL refuses two
  ranks on one device.  gloo moves CUDA tensors in ``all_reduce``,
  ``all_gather`` and ``all_to_all_single`` by staging them through the
  host, but a CUDA tensor in its ``send``/``recv`` aborts the process
  (``tools/torch_gloo_cuda_probe.py`` on an H100): the halo exchange picks
  its transport from that (``parallel/halo.py``).

:func:`launch` starts ``n`` rank processes with the ``spawn`` start method
(the parent may have initialised CUDA), meets them through a file store in
a temporary directory (no fixed TCP port, so concurrent launches do not
collide), runs ``fn(group, *args)`` in each and returns the per-rank
results.  A rank that raises, dies or outlives the timeout fails the whole
call: the parent polls every process, kills the rest and raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's view of its group of ranks.  ``world_size == 1``
    without an initialised process group is a single rank: every
    collective is the identity."""

    world_size: int
    rank: int
    device: torch.device
    backend: str               # "nccl", "gloo" or "none" (single rank)

    @property
    def distributed(self) -> bool:
        return self.backend != "none"

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        if not self.distributed:
            return t
        out = t.clone()
        dist.all_reduce(out)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape on all ranks), concatenated in
        rank order along dim 0."""
        if not self.distributed:
            return t
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def device_mesh(n_devices: Optional[int] = None,
                device="cuda") -> RankGroup:
    """The group of ranks this process belongs to (the port's counterpart
    of ``femus_tpu.parallel.spmd.device_mesh``): inside a rank started by
    :func:`launch`, the initialised process group, which must hold
    ``n_devices`` ranks; outside one, a single rank on ``device``."""
    if dist.is_available() and dist.is_initialized():
        ws = dist.get_world_size()
        if n_devices is not None and n_devices != ws:
            raise ValueError(f"device_mesh({n_devices}) in a group of {ws}")
        backend = dist.get_backend()
        rank = dist.get_rank()
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return RankGroup(ws, rank, dev, backend)
    if n_devices not in (None, 1):
        raise ValueError(f"device_mesh({n_devices}) outside a launched "
                         "group of ranks (parallel.ranks.launch)")
    from .. import resolve_device
    return RankGroup(1, 0, resolve_device(device), "none")


def choose_backend(n: int, device: str) -> dict:
    """The backend of ``n`` ranks on ``device`` ("cuda" or "cpu"), with the
    rule that chose it."""
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if n <= cards:
            return {"backend": "nccl", "ranks": n, "cards": cards,
                    "share_card": False,
                    "rule": "every rank has a card of its own"}
        return {"backend": "gloo", "ranks": n, "cards": cards,
                "share_card": True,
                "rule": f"{n} ranks share {cards} card(s): NCCL refuses two "
                        "ranks on one device"}
    return {"backend": "gloo", "ranks": n, "cards": 0, "share_card": False,
            "rule": "ranks on the CPU"}


def _rank_entry(rank: int, n: int, backend: str, device: str, store: str,
                out_dir: str, threads: int, fn: Callable, args: tuple):
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=n, rank=rank)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        group = device_mesh(n, device)
        result = fn(group, *args)
        if group.device.type == "cuda":
            torch.cuda.synchronize()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        # the parent reads the traceback from the file and raises
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n: int, args: Sequence = (), device: str = "cuda",
           timeout: float = 600.0, quiet: bool = False) -> List[Any]:
    """Run ``fn(group, *args)`` in ``n`` rank processes; returns the list
    of their results (rank order).  ``fn`` must be a module-level function
    of an importable module, ``args`` and the results picklable.  Prints
    the backend rule (one JSON line) unless ``quiet``.  Raises if any rank
    raises, dies or is still running after ``timeout`` seconds."""
    import torch.multiprocessing as mp

    rule = choose_backend(n, device)
    if not quiet:
        print(json.dumps({"ranks": rule}), flush=True)
    # host threads per rank: one on the CPU (the ranks share its cores
    # with each other and with the test workers), the host's cores split
    # evenly beside a card
    threads = 1 if torch.device(device).type == "cpu" else \
        max(1, (os.cpu_count() or 1) // n)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_entry, args=(
            r, n, rule["backend"], device, store, tmp, threads, fn,
            tuple(args)), daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            else:
                failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        if failed:
            # every rank that left a traceback (the first failure and the
            # ranks its death broke), then any other non-zero exit
            errs = []
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path) or r in failed:
                    text = open(path).read() if os.path.exists(path) else ""
                    errs.append(f"rank {r} exit {p.exitcode}:\n{text}")
            raise RuntimeError("launch: rank(s) failed\n" + "\n".join(errs))
        if any(p.exitcode != 0 for p in procs):
            raise TimeoutError(f"launch: ranks still running after "
                               f"{timeout} s (exit codes "
                               f"{[p.exitcode for p in procs]})")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
