"""Production-mesh dry run: cost one rank's step of every (arch x shape) cell.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for the 16 x 16 (or 2 x 16 x 16) mesh on forced host
devices and reads the compiled module.  Here one process stands for rank 0
of a world of 256 (or 512) ranks on the ``fake`` process-group backend
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once, moving nothing), builds the cell from its full config on fake
tensors (``FakeTensorMode``: shapes and dtypes on ``--device``, no memory,
no data), and runs the rank's step once under
:class:`~repro_torch.launch.hlo_cost.CostMode`, which counts what the step
dispatches.  Nothing runs on a card; ``--device cuda`` (the default) needs a
CUDA build of PyTorch, not a card; ``--device cpu`` traces the same program
on CPU fake tensors.

**What rank 0 runs** is what the port runs on a mesh:

* ``train``: ``make_train_step(model, shardings=)`` (``launch/steps.py``),
  the reference's GSPMD layout: the parameters and AdamW moments rest
  split by the reference's rules (``parallel/sharding.py``), each layer's
  leaves are all-gathered over ``data`` inside its checkpointed layer and
  their gradients reduce-scattered as the backward leaves it, and the
  model splits its work over ``model`` (the sequence between sublayers,
  q heads or query rows, ``d_ff``, experts, RWKV's recurrence on the
  rank's rows, the hybrid's ``d_inner``, the logits of the rank's own
  tokens) on its rows of the global batch (split over ``pod`` and
  ``data``).
* ``prefill`` / ``decode``: the reference's serving cell, every family.
  The weights rest in their shards (the training rules, or the serving
  rules with ``--serve-params``) and each layer's are gathered when it
  runs, a ``model`` split kept where the work is split by it (q heads,
  ``d_ff``, ``d_inner``, experts, the vocabulary); ``make_prefill_fn`` /
  ``make_decode_fn(shardings=, layout=)`` run on the rank's rows of the
  batch (split over ``pod`` and ``data`` where they divide), the prefill
  sequence-parallel over ``model``, and the decode state is the rank's
  shards of ``decode_state_shardings(layout=--decode-layout)``: the
  cache's rows (``seq``) or kv heads (``heads``), whisper's cross K/V by
  heads, RWKV's ``wkv`` by value columns and the hybrid's ``ssm_h`` by
  ``d_inner``, each split over ``model`` where the axis divides it, else
  whole, as the reference lays it out.

The model is built with ``impl="xla"``, as the reference's dry run
builds it: the plain routes, never a kernel; and with the layer remat
policy of ``--remat`` (``full``, ``dots`` or ``none``, recorded as
``remat``), so the count is what the step under that policy runs and
keeps: ``full`` reruns each layer's forward in the backward, ``dots``
reruns all but the products with no batch dimension, whose outputs it
keeps, ``none`` reruns nothing and keeps what autograd saves (on a mesh a
saved gathered leaf as its shard, gathered again in the backward).  The
plain per-token recurrences (RWKV6, the hybrid's SSM) are counted on 128
tokens and scaled (``hlo_cost.token_loop``), their 64-token chunk
checkpoints with them.

Per cell it records the reference's keys: per-rank FLOPs, HBM bytes and
collective wire bytes, the collectives by kind, the roofline terms on the
H100 datasheet constants of ``hlo_cost`` and the useful-FLOP ratio
``model_flops / (flops * chips)``, and ``memory`` from the trace: the
resident bytes (``argument_bytes``), the peak (``peak_bytes``) and whether
it fits one H100's 80 GB (``fits``).  Where the reference has no
counterpart in an eager trace: ``lower_s`` is the time to build the cell,
``compile_s`` the time of the counted trace, ``xla_cost_analysis`` the
trace's own count (it dispatches every loop trip, so it has no
single-visit count: FLOPs as counted, bytes as the eager count) and
``transcript_lines`` the operations counted.

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage::

    python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
    python -m repro_torch.launch.dryrun --arch whisper-tiny \\
        --shape decode_32k --device cpu --out /tmp/drt
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from ..configs import SHAPES, cells_for, get_config, list_archs
from ..models import build_model
from ..models.common import REMAT_POLICIES, ArchConfig, param_tree
from ..optim import adamw_init
from ..parallel.sharding import BATCH_AXES, decode_state_shardings, \
    param_shardings, shard_tree
from ..tree import tree_leaves, tree_map
from .hlo_cost import analyze_graph
from .mesh import make_production_mesh
from .steps import make_batch_stub, make_decode_fn, make_prefill_fn, \
    make_train_step

__all__ = ["CARD_BYTES", "LOOP_CHUNK", "build_cell", "model_flops",
           "run_cell"]

#: one H100 SXM's HBM, datasheet (80 GB)
CARD_BYTES = 80e9

#: tokens a plain per-token recurrence is counted on before scaling
LOOP_CHUNK = 128


def model_flops(cfg: ArchConfig, kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS = 6·N_active·tokens (train) / 2·N·tokens (fwd)."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch  # decode: one token per sequence


def _fake_world(size: int) -> None:
    """This process as rank 0 of a world of ``size`` on the fake backend
    (the world of an earlier cell of the same size is reused)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _fake(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def build_cell(arch: str, shape_name: str, mesh, *,
               serve_params: bool = False, decode_layout: str = "seq",
               remat: str = "full") -> Tuple[Any, tuple, Dict[str, Any]]:
    """(step, its arguments, meta) of rank 0's step on ``mesh`` (a
    production mesh on the fake world), the model built with the layer
    remat policy ``remat``; call it inside a ``FakeTensorMode``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    dev = mesh.device
    model = build_model(cfg, device=dev, impl="xla", remat=remat)
    n_batch = math.prod(mesh.shape.get(a, 1) for a in BATCH_AXES)
    divisible = shape.global_batch % n_batch == 0
    rows = shape.global_batch // n_batch if divisible else shape.global_batch
    hd_div = cfg.num_heads % mesh.shape["model"] == 0

    full = param_tree(model)
    mode = "serve" if serve_params and shape.kind != "train" else "train"
    shardings = param_shardings(full, mesh, mode=mode, heads_divisible=hd_div)
    shards = tree_map(torch.clone, shard_tree(full, shardings))

    if shape.kind == "train":
        batch = {k: _fake(v, dev) for k, v in make_batch_stub(
            cfg, batch=shape.global_batch, seq=shape.seq_len,
            kind="train").items()}
        step = make_train_step(model, shardings=shardings)
        args = (shards, adamw_init(shards), batch)
    elif shape.kind == "prefill":
        batch = {k: _fake(v, dev) for k, v in make_batch_stub(
            cfg, batch=shape.global_batch, seq=shape.seq_len,
            kind="prefill").items()}
        step = make_prefill_fn(model, max_seq=shape.seq_len,
                               shardings=shardings, layout=decode_layout)
        args = (shards, batch)
    else:
        whole = model.init_decode_state(shape.global_batch, shape.seq_len)
        state = tree_map(torch.clone, shard_tree(
            whole, decode_state_shardings(
                whole, mesh, layout=decode_layout,
                batch_divisible=divisible)))
        tokens = torch.zeros((rows,), dtype=torch.int32, device=dev)
        step = make_decode_fn(model, shardings=shardings,
                              layout=decode_layout, max_seq=shape.seq_len)
        args = (shards, state, tokens)

    meta = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "chips": mesh.size, "decode_layout": decode_layout, "remat": remat,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "model_flops": model_flops(cfg, shape.kind, shape.global_batch,
                                   shape.seq_len),
        "rank_rows": rows, "device": str(dev),
        "param_mode": mode,
    }
    return step, args, meta


def _out_bytes(out) -> float:
    """Bytes of the distinct storages of a step's results."""
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _leaves(out)}
    return float(sum(storages.values()))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: Path,
             device="cuda", serve_params: bool = False, tag: str = "",
             decode_layout: str = "seq", remat: str = "full"
             ) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode

    _fake_world(512 if multi_pod else 256)
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, meta = build_cell(arch, shape_name, mesh,
                                      serve_params=serve_params,
                                      decode_layout=decode_layout,
                                      remat=remat)
        t_build = time.time() - t0
        t0 = time.time()
        hc, out = analyze_graph(step, args, loop_chunk=LOOP_CHUNK)
        t_trace = time.time() - t0
        out_bytes = _out_bytes(out)
        del out, step, args
    chips = meta["chips"]
    rf = hc.roofline()
    flops = hc.flops
    rf["useful_flop_ratio"] = (meta["model_flops"] / (flops * chips)
                               if flops else 0.0)
    peak = hc.peak_bytes
    result = {
        **meta,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_trace, 2),
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": hc.bytes,
        "hlo_bytes_eager_per_chip": hc.bytes_eager,
        "collective_wire_bytes_per_chip": hc.wire_bytes,
        "collectives": hc.collectives,
        "wire_by_link": hc.wire_by_link,
        "flops_by_dtype": hc.flops_by_dtype,
        "while_trip_counts": hc.while_trip_counts[:8],
        "xla_cost_analysis": {"flops_single_visit": flops,
                              "bytes_single_visit": hc.bytes_eager},
        "memory": {
            "argument_bytes": hc.resident_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": peak - hc.resident_bytes,
            "alias_bytes": None,
            "peak_bytes": peak,
            "card_bytes": CARD_BYTES,
            "fits": peak <= CARD_BYTES,
        },
        "roofline": rf,
        "loop_chunk": LOOP_CHUNK,
        "transcript_lines": hc.ops,
        "ok": True,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch.replace('/', '_')}__{shape_name}__{meta['mesh']}"
    if tag:
        name += f"__{tag}"
    (out_dir / f"{name}.json").write_text(json.dumps(result, indent=1))
    return result


def _leaves(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--decode-layout", default="seq", choices=["heads", "seq"])
    ap.add_argument("--remat", default="full", choices=REMAT_POLICIES)
    ap.add_argument("--tag", default="")
    ap.add_argument("--serve-params", action="store_true",
                    help="rest the weights of decode/prefill in the serving "
                         "rules' shards (dense weights split over model, "
                         "not data)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda needs a CUDA "
                         "build of PyTorch, not a card)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    cells = []
    if args.all:
        for arch in list_archs():
            for shape in cells_for(arch):
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        if args.shape not in cells_for(args.arch):
            print(f"[n/a]  {args.arch}__{args.shape} (DESIGN.md §4 skip)")
            return
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if torch.device(args.device).type == "cuda" and \
            not torch.backends.cuda.is_built():
        raise SystemExit("this PyTorch has no CUDA build, so it cannot make "
                         "fake CUDA tensors: pass --device cpu")

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            fname = f"{arch}__{shape}__{mesh_name}"
            if args.tag:
                fname += f"__{args.tag}"
            if args.skip_existing and (out_dir / f"{fname}.json").exists():
                print(f"[skip] {fname}")
                continue
            t0 = time.time()
            try:
                r = run_cell(arch, shape, multi_pod=mp, out_dir=out_dir,
                             device=args.device,
                             serve_params=args.serve_params, tag=args.tag,
                             decode_layout=args.decode_layout,
                             remat=args.remat)
                rf, mem = r["roofline"], r["memory"]
                print(
                    f"[ok]   {fname}  trace={r['compile_s']:.0f}s "
                    f"flops/chip={r['hlo_flops_per_chip']:.3e} "
                    f"dom={rf['dominant']} "
                    f"bound={rf['step_s_lower_bound']*1e3:.2f}ms "
                    f"useful={rf['useful_flop_ratio']:.3f} "
                    f"peak={mem['peak_bytes']/1e9:.1f}/"
                    f"{CARD_BYTES/1e9:.0f}GB",
                    flush=True,
                )
            except Exception as e:
                failures += 1
                print(f"[FAIL] {fname}  {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
                out_dir.mkdir(parents=True, exist_ok=True)
                (out_dir / f"{fname}.FAILED.txt").write_text(
                    f"{e}\n{traceback.format_exc()}")
            print(f"       ({time.time()-t0:.0f}s)", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
