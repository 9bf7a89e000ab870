"""Try a world of two ranks through NCCL on the visible cards.

    python -m bio_image_unet_tpu_torch.utils.nccl_two_ranks [--world 2] [--timeout 120]

Starts ``--world`` processes; rank ``r`` joins the group with
``parallel.initialize_distributed`` (NCCL, bound to card ``r`` modulo the card
count, so on a machine with one card every rank binds the same card), builds
``get_mesh()`` and all-gathers 1 MiB of uint8 and all-reduces a float32
vector over it.  Prints one JSON line: each rank's outcome (``ok``, or the
error it raised, or ``"no answer"`` when it hung past ``--timeout`` and was
killed), its card, its set-up seconds and the collectives' results and
seconds.  Every process it starts is stopped before it exits; the exit code
is 0 whatever the ranks did.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import queue as queue_mod
import socket
import time
from datetime import timedelta


def _rank(rank: int, world: int, port: int, out) -> None:
    import torch
    import torch.distributed as dist

    from bio_image_unet_tpu_torch.parallel import get_mesh, initialize_distributed

    res = {"rank": rank}
    try:
        t0 = time.perf_counter()
        initialize_distributed(backend="nccl", rank=rank, world_size=world,
                               init_method=f"tcp://127.0.0.1:{port}",
                               timeout=timedelta(seconds=60))
        mesh = get_mesh()
        res.update(card=torch.cuda.current_device(), setup_s=time.perf_counter() - t0)
        x = torch.full((1 << 20,), rank + 1, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = mesh.all_gather(x)
        torch.cuda.synchronize()
        res["all_gather_s"] = time.perf_counter() - t0
        v = torch.full((1024,), float(rank + 1), device="cuda")
        t0 = time.perf_counter()
        mesh.all_reduce(v)
        torch.cuda.synchronize()
        res.update(all_reduce_s=time.perf_counter() - t0,
                   gathered=[int(g[i * x.numel()]) for i in range(world)],
                   reduced=float(v[0]), ok=True)
        dist.destroy_process_group()
    except Exception as err:  # the outcome is what this script reports
        res.update(ok=False, error=f"{type(err).__name__}: {err}"[:2000])
        if dist.is_initialized():
            dist.destroy_process_group()
    out.put(res)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--timeout", type=float, default=120.0)
    args = p.parse_args(argv)
    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, args.world, port, out))
             for r in range(args.world)]
    for proc in procs:
        proc.start()
    results, deadline = {}, time.monotonic() + args.timeout
    try:
        while len(results) < args.world and time.monotonic() < deadline:
            try:
                res = out.get(timeout=1.0)
                results[res["rank"]] = res
            except queue_mod.Empty:
                pass
    finally:
        for proc in procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join()
    ranks = [results.get(r, {"rank": r, "ok": False, "error": "no answer"})
             for r in range(args.world)]
    print(json.dumps({"world": args.world, "cards": torch.cuda.device_count(),
                      "ranks": ranks}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
