"""Start the ranks of a mesh run: one process per mesh position.

`spawn(fn, args, world_size, device)` starts `world_size` processes (the
'spawn' start method), joins each to one process group and runs
`fn(*args)` in each; it returns the ranks' results in rank order.  The
backend follows from the layout and is printed once: NCCL where each rank
has a card of its own, gloo where ranks share a card or run on the CPU
(`mesh.world_backend`).  A rank that raises fails the whole run: the parent
kills the other ranks (which would wait in their next collective) and
raises the first error with its traceback; so does a rank that dies, and a
run that outlasts `timeout`.  CPU ranks take one thread each.

Under torchrun the ranks exist already, on one host or on several:
`init_from_env` joins the group from the environment, with the backend of
the whole world (NCCL only where no two ranks share a card).  `run` is what the entry points call: in a rank, or
under torchrun, fn runs in this process; otherwise the ranks are spawned
and rank 0's result returned.

`fn` and its arguments are pickled into the new processes, so fn must be a
module-level function of a module that imports cleanly there.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from cooperativeimagecaptioning_tpu_torch.parallel.mesh import (
    GROUP_TIMEOUT, card_id, rank_device, world_backend)


def free_init_method() -> str:
    """A tcp:// address on this host with a port the system just gave out."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def init_rank(rank: int, world_size: int, init_method: str, device: str,
              backend: str, store=None) -> None:
    """Join the process group as `rank` (through `store` where given, else
    `init_method`)."""
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank_device(device, rank))
    kw = {"init_method": init_method} if store is None else {"store": store}
    dist.init_process_group(backend, world_size=world_size, rank=rank,
                            timeout=GROUP_TIMEOUT, **kw)


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def exchange_cards(store, rank: int, world: int, card) -> list:
    """Every rank's card id, in rank order, through the rendezvous store
    (each rank sets its own key and reads the others')."""
    store.set(f"cic_card/{rank}", "" if card is None else card)
    out = []
    for r in range(world):
        got = store.get(f"cic_card/{r}").decode()
        out.append(got or None)
    return out


def init_from_env(device: str) -> str:
    """Join the group that torchrun's environment describes (ranks on one
    host or on several); returns the backend.  The backend is the whole
    world's: the ranks first exchange their cards' UUIDs through the
    rendezvous store, and take NCCL only where no two of them share a card
    (`mesh.world_backend`) -- ranks of two hosts may share one."""
    store, rank, world = next(dist.rendezvous(
        "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
        timeout=GROUP_TIMEOUT))
    store.set_timeout(GROUP_TIMEOUT)
    backend = world_backend(device, exchange_cards(
        store, rank, world, card_id(device, rank)))
    if rank == 0:
        hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
        print(f"mesh: {world} ranks on {hosts} host(s) over {backend} "
              f"(torchrun)", flush=True)
    init_rank(rank, world, "env://", device, backend,
              store=dist.PrefixStore("default_pg", store))
    return backend


def _rank_main(rank, world_size, init_method, device, backend, fn, args,
               results):
    try:
        init_rank(rank, world_size, init_method, device, backend)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which re-raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, args=(), world_size: int = 2, device: str = "cuda",
          timeout: float = 900.0) -> list:
    """fn(*args) in `world_size` new ranks -> their results, in rank
    order.  The ranks run on the card unless the caller passes
    device="cpu"."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"spawn: device {device!r} asked for but no CUDA device is "
            f"available (pass device='cpu' to run the ranks on the host)")
    # one host: a rank's card is its device (no CUDA context in the parent)
    backend = world_backend(device, [
        None if device == "cpu" else rank_device(device, r)
        for r in range(world_size)])
    init_method = free_init_method()
    where = "the CPU" if device == "cpu" else (
        "one card each" if backend == "nccl" else "shared cards")
    print(f"mesh: {world_size} ranks over {backend} on {where}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, init_method, device, backend,
                               fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"mesh rank {r} of {world_size} exited with code "
                            f"{p.exitcode} before it reported")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"mesh ranks still running after "
                                       f"{timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} of {world_size} "
                                   f"failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10.0)
        results.close()
    return [got[r] for r in range(world_size)]


def run(fn, args, world_size: int, device: str):
    """fn(*args) as the entry points run it: in this process when it is a
    rank already (or torchrun started it), else in `world_size` spawned
    ranks, returning rank 0's result."""
    if dist.is_initialized():
        return fn(*args)
    if under_torchrun():
        init_from_env(device)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    return spawn(fn, args, world_size, device)[0]
