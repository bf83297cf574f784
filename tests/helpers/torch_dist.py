"""Run a function on N ``torch.distributed`` ranks (gloo, spawned
processes, a ``file://`` rendezvous under the test's ``tmp_path``).

The ranks import this module and the function's, never jax: the function
must live in a torch-only module.  Results come back in rank order; a
rank that raises fails the call with its traceback.
"""

import datetime
import multiprocessing as mp
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import bind_axis, compressed_grad_tree
from repro_torch.parallel.collectives import compressed_psum, maybe_psum

__all__ = ["run_ranks"]


def _rank_main(fn, rank, n, init, out, args):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=n,
                                timeout=datetime.timedelta(seconds=60))
        try:
            out.put((rank, "ok", fn(rank, n, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:
        out.put((rank, "err", traceback.format_exc()))


def run_ranks(fn, n, tmp_path, *args, timeout=120):
    """``fn(rank, n, *args)`` on each of ``n`` ranks: their results."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, init, out, args),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < n:
            rank, status, value = out.get(timeout=timeout)
            if status == "err":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    except queue.Empty:
        raise RuntimeError(f"ranks {sorted(set(range(n)) - set(results))} "
                           f"gave no result in {timeout}s") from None
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(n)]


# ------------------------------------------------ rank functions (tests)

def psum_ranks(rank, n, xs):
    """``maybe_psum`` of rank ``rank``'s int32 block, with the world group
    bound to ``model`` and with nothing bound."""
    x = torch.from_numpy(xs[rank])
    with bind_axis("model", dist.group.WORLD):
        summed = maybe_psum(x).numpy()
        other_axis = maybe_psum(x, "pod").numpy()
    return summed, other_axis, maybe_psum(x).numpy()


def compressed_psum_ranks(rank, n, xs):
    return compressed_psum(torch.from_numpy(xs[rank])).numpy()


def compressed_grad_tree_ranks(rank, n, trees):
    """The compressed sum over ``pod`` of a (pod=2, model=n/2) mesh, and
    the tree unchanged over an axis the mesh lacks."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, n // 2),
                            mesh_dim_names=("pod", "model"))
    grads = {k: torch.from_numpy(v) for k, v in trees[rank].items()}
    out = compressed_grad_tree(grads, mesh, "pod")
    same = compressed_grad_tree(grads, mesh, "data")
    return ({k: v.numpy() for k, v in out.items()},
            all(same[k] is grads[k] for k in grads),
            np.asarray(mesh.mesh))
