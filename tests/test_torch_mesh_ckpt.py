"""Checkpoints of the port's training mesh, and its launcher under
``torchrun``.

A save from a 2 x 2 mesh (4 gloo ranks: each gathers every leaf, rank 0
writes) is byte for byte the one-device save of the same values.  A run
moved across mesh shapes by its checkpoints, 2 x 2 for two steps, 1 x 2
for two more, then one device for two, ends where an uninterrupted
one-device run of six steps ends, within ``tests/test_torch_train.py``'s
limits (losses rtol 1e-4, gradient norms 1e-3, each leaf's change within
5e-3 of its size): the mesh changes no value of a dense model, only the
order of some sums.  ``launch/train.py`` under ``torch.distributed.run``
on 2 CPU ranks trains, resumes from its checkpoint, and logs what the
single-process launcher logs: step 0 to the printed digits, the later
steps within the bf16 limits below (the reduced config's dtype).  ``make_production_mesh`` refuses a
world that is not its 256 or 512 ranks.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from helpers import torch_mesh
from helpers.torch_dist import run_ranks

import repro_torch.data as PD
import repro_torch.optim as PO
import repro_torch.runtime as PR
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.core.gofer import Gofer
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.common import param_tree
from repro_torch.tree import tree_flatten_with_path

LOSS_RTOL, GNORM_RTOL, UPDATE_REL = 1e-4, 1e-3, 5e-3
#: the launcher trains the reduced config in bf16: a loss within one bf16
#: rounding (2**-8), a gradient norm within 5 % (the reference's own bf16
#: mesh run moves gemma2's norm by 1 % in one step, and AdamW's normalised
#: steps carry rounding-level sign flips of the gradient into the weights;
#: 2 and 4 steps on: 3e-4 and 2 % here)
BF16_LOSS_RTOL, BF16_GNORM_RTOL = 2.0 ** -8, 5e-2
SEQ = 16
ROOT = Path(__file__).resolve().parents[1]


def _cfg():
    return dataclasses.replace(get_reduced("gemma2-9b"), dtype="float32")


def _weights(cfg):
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    flat = {"/".join(map(str, p)): t.numpy().copy()
            for p, t in tree_flatten_with_path(param_tree(model))}
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return model, out


def _nested_tensors(records):
    out = {}
    for key, v in records.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(np.asarray(v))
    return out


def _one_device(model, cfg, steps, ckpt=None, start=0):
    dc = PD.DataConfig(global_batch=4, seq_len=SEQ,
                       vocab_size=cfg.vocab_size)
    loader = PD.Loader(torch_mesh.MaskedLM(PD.SyntheticLM(dc)), dc,
                       start_step=start)
    tr = PR.Trainer(model, loader,
                    torch_mesh.trainer_cfg(PR, PO, 1, steps), ckpt=ckpt)
    params = param_tree(model)
    opt = PO.adamw_init(params)
    if start:
        restored = ckpt.restore_latest({"params": params, "opt": opt},
                                       device="cpu")
        assert restored[0] == start
        params, opt = restored[1]["params"], restored[1]["opt"]
    params, _ = tr.run(params, opt, start_step=start)
    loader.stop()
    return tr.metrics_log, {"/".join(map(str, k)): t.numpy()
                            for k, t in tree_flatten_with_path(params)}


def test_mesh_save_is_the_one_device_save_and_moves_across_meshes(tmp_path):
    cfg = _cfg()
    model, weights = _weights(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    root = tmp_path / "ckpt"
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    a = run_ranks(torch_mesh.ckpt_ranks, 4, tmp_path / "a", 2, 2, cfg,
                  weights, SEQ, str(root), 2, 0, 10 ** 9)[0]
    ckpt = CheckpointManager(Gofer.for_root("ckpt", root, write=True),
                             keep=10)
    assert ckpt.all_steps() == [2]
    image = ckpt.gofer.read_bytes("ckpt", "step_00000002.self")
    # the one-device save of the same values
    one = CheckpointManager(Gofer.for_root("ckpt", tmp_path / "one",
                                           write=True))
    one.save(2, {"params": _nested_tensors(a["params"]),
                 "opt": _nested_tensors(a["opt"])}, blocking=True)
    assert one.gofer.read_bytes("ckpt", "step_00000002.self") == image

    b = run_ranks(torch_mesh.ckpt_ranks, 2, tmp_path / "b", 1, 2, cfg,
                  weights, SEQ, str(root), 4, 2, 10 ** 9)[0]
    assert ckpt.all_steps() == [2, 4]
    log_c, params_c = _one_device(model, cfg, 6, ckpt=ckpt, start=4)

    model.load_state_dict(start)
    log, params = _one_device(model, cfg, 6)
    for got, want in zip(a["log"] + b["log"] + log_c, log):
        assert got["step"] == want["step"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"],
                                   rtol=GNORM_RTOL)
    assert len(a["log"] + b["log"] + log_c) == len(log) == 6
    init = {"/".join(map(str, p)): t.numpy() for p, t in
            tree_flatten_with_path(_nested_tensors(
                {k.replace(".", "/"): v.numpy() for k, v in start.items()}))}
    for key, want in params.items():
        moved = np.linalg.norm(want.astype(np.float64) - init[key])
        err = np.linalg.norm(params_c[key].astype(np.float64) - want)
        assert err <= UPDATE_REL * moved + 1e-12, (key, err, moved)


ROW = re.compile(r"\[train\] step\s+(\d+) loss ([\d.]+) gnorm ([\d.]+)")


def _launch(tmp_path, ckpt_dir, extra, ranks=0):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    pre = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={ranks}"] if ranks else [sys.executable]
    cmd = pre + ["-m", "repro_torch.launch.train", "--arch", "gemma2-9b",
                 "--reduced", "--device", "cpu", "--seq", "32",
                 "--global-batch", "4", "--ckpt-dir", str(ckpt_dir)] + extra
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launcher_under_torchrun_trains_and_resumes_as_one_process(tmp_path):
    runs = {}
    for ranks in (2, 0):
        d = tmp_path / f"ckpt{ranks}"
        first = _launch(tmp_path, d, ["--steps", "3"], ranks)
        second = _launch(tmp_path, d, ["--steps", "5", "--resume"], ranks)
        assert "resumed from step 3" in second
        assert "mesh={'data': %d, 'model': 1}" % max(ranks, 1) in first
        assert first.count("[train] done") == 1      # rank 0 logs alone
        runs[ranks] = [(int(s), float(l), float(g)) for s, l, g in
                       ROW.findall(first + second)]
    assert [r[0] for r in runs[2]] == [r[0] for r in runs[0]] == [0, 2, 4]
    # step 0 (no update yet): the same loss and norm to the printed digits
    # but the last of the norm; after it, bf16 steps drift (the module
    # docstring)
    (_, l2, g2), (_, l1, g1) = runs[2][0], runs[0][0]
    assert l2 == l1 and abs(g2 - g1) <= 1e-3 * g1
    for (_, l2, g2), (_, l1, g1) in zip(runs[2][1:], runs[0][1:]):
        assert abs(l2 - l1) <= BF16_LOSS_RTOL * l1
        assert abs(g2 - g1) <= BF16_GNORM_RTOL * g1


@pytest.mark.parametrize("multi_pod,size", [(False, 256), (True, 512)])
def test_production_mesh_refuses_another_world(multi_pod, size):
    with pytest.raises(ValueError, match=f"needs {size} ranks; the world "
                                         "has 1"):
        make_production_mesh(multi_pod=multi_pod)
