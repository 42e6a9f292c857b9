"""Which torch.distributed collectives take CUDA tensors on a gloo group.

Two ranks share card 0 over gloo (rendezvous through a file store in a
temporary directory); each collective the multi-device layer could use is
tried once on CUDA tensors and its outcome printed, one JSON line per rank.
Then one rank on NCCL (world size 1) runs an all_reduce.  This is a probe,
not a path of the package: the package picks its transport by rule from
what this prints (femus_tpu_torch/parallel/halo.py).

    python tools/torch_gloo_cuda_probe.py
"""
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _try(name, fn, out):
    try:
        fn()
        torch.cuda.synchronize()
        out[name] = "ok"
    except Exception as exc:            # a probe records every refusal
        out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"


def rank_main(rank, world, store, backend):
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    out = {"rank": rank, "backend": backend, "world": world}
    x = torch.full((8,), float(rank + 1), device=dev)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        assert float(y[0]) == world * (world + 1) / 2, y

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ys, x)

    def all_to_all_single():
        y = torch.empty(world * 4, device=dev)
        dist.all_to_all_single(y, torch.arange(world * 4.0, device=dev))

    def all_to_all_single_async():
        y = torch.empty(world * 4, device=dev)
        dist.all_to_all_single(y, torch.arange(world * 4.0, device=dev),
                               async_op=True).wait()

    def send_recv():
        if world < 2:
            return
        peer = 1 - rank
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, y, peer)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        assert float(y[0]) == peer + 1, y

    def send_recv_host():
        if world < 2:
            return
        peer = 1 - rank
        xs = x.cpu().pin_memory()
        y = torch.empty(8).pin_memory()
        ops = [dist.P2POp(dist.isend, xs, peer), dist.P2POp(dist.irecv, y, peer)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        assert float(y[0]) == peer + 1, y

    for name, fn in [("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("all_to_all_single", all_to_all_single),
                     ("all_to_all_single_async", all_to_all_single_async),
                     ("batch_isend_irecv_host", send_recv_host),
                     # last: a refused CUDA send on gloo breaks the pair
                     ("batch_isend_irecv_cuda", send_recv)]:
        _try(name, fn, out)
        print(json.dumps(out), flush=True)
        if name != "batch_isend_irecv_cuda" and backend == "gloo":
            dist.barrier()
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    for backend, world in (("gloo", 2), ("nccl", 1)):
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            procs = [ctx.Process(target=rank_main,
                                 args=(r, world, store, backend))
                     for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
                if p.is_alive():
                    p.kill()
                    print(f"{backend}: a rank hung", file=sys.stderr)
                    return 1
            print(f"{backend}: exit codes {[p.exitcode for p in procs]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
