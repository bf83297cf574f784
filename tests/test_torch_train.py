"""The port's ``Trainer``, ``TrainStepper`` and training launcher.

The 5-step loss curves and final parameters match the reference's
``Trainer(donate=False)`` from the same ``init`` weights and the same
``SyntheticLM`` batches, fp32 on the CPU, with ``accum_steps`` 1 and 2.
Tolerances: the losses within rtol 1e-4, the gradient norms within rtol
1e-3, the learning rates within rtol 1e-6, and each parameter leaf's
change over the run within 5e-3 of its size (relative L2).  The first
step's loss agrees to fp32 rounding; after it the two runs drift apart
because AdamW divides each gradient entry by its own running magnitude,
so an entry near ``eps`` (a fp32 rounding's worth of gradient) moves by up
to the learning rate on one side and not the other; the largest changes
these cases show on the CPU are 1.5e-5 of a loss and 6e-4 of a leaf's
update.

Recovery follows the reference: restore the latest checkpoint and resume
at its step with the loader's next batch (compared with the reference's
own recovered run, and bit for bit with an uninterrupted port run one
step longer), or, before the first checkpoint, restart from
``init_state(0)``.  ``TrainStepper.step_once`` under the port's scheduler
gives the same parameters as ``Trainer.run``, bit for bit.
"""

import numpy as np
import pytest
import torch

import repro.data as JD
import repro.optim as JO
import repro.runtime as JR
import repro_torch.data as PD
import repro_torch.optim as PO
import repro_torch.runtime as PR
from helpers.torch_port import fp32_config, model_pair
from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint.ckpt import tree_to_records as ref_records
from repro.core.gofer import Gofer as RefGofer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import tree_to_records
from repro_torch.core import ServerlessScheduler, TaskSpec, TaskState
from repro_torch.core.admission import system_task
from repro_torch.core.gofer import Gofer
from repro_torch.launch.train import main as train_main
from repro_torch.models.common import param_tree

LOSS_RTOL, GNORM_RTOL, LR_RTOL, UPDATE_REL = 1e-4, 1e-3, 1e-6, 5e-3
STEPS = 5


class FramesLM:
    """A package's ``SyntheticLM`` plus seeded encoder frames (whisper's
    stub input), keyed by step as the tokens are."""

    def __init__(self, base, cfg):
        self.base, self.cfg = base, cfg

    def batch_at(self, step):
        b = self.base.batch_at(step)
        rng = np.random.default_rng(step)
        b["frames"] = rng.standard_normal(
            (b["tokens"].shape[0], self.cfg.encoder_len, self.cfg.d_model)
        ).astype(np.float32)
        return b


@pytest.fixture
def one_thread():
    """Bit-for-bit comparisons of two CPU runs: with several intra-op
    threads, one training run is not bitwise repeatable on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer_cfg(pkg, opt, accum, steps=STEPS, ckpt_every=10**9):
    return pkg.TrainerConfig(
        total_steps=steps, accum_steps=accum, log_every=1,
        ckpt_every=ckpt_every,
        schedule=opt.ScheduleConfig(peak_lr=3e-3, warmup_steps=2,
                                    decay_steps=STEPS))


def _dataset(data, cfg, seq=16, start=0):
    dc = data.DataConfig(global_batch=4, seq_len=seq,
                         vocab_size=cfg.vocab_size)
    ds = data.SyntheticLM(dc)
    if cfg.family == "audio":
        ds = FramesLM(ds, cfg)
    return data.Loader(ds, dc, start_step=start)


def _ref_run(jax_model, params, cfg, accum, steps=STEPS, **kw):
    loader = _dataset(JD, cfg)
    tr = JR.Trainer(jax_model, loader,
                    _trainer_cfg(JR, JO, accum, steps, kw.pop("ckpt_every",
                                                              10**9)),
                    donate=False, **kw)
    p, o = tr.run(params, JO.adamw_init(params))
    loader.stop()
    return tr, p, o


def _port_run(model, cfg, accum, steps=STEPS, params=None, start=0, **kw):
    loader = _dataset(PD, cfg, start=start)
    tr = PR.Trainer(model, loader,
                    _trainer_cfg(PR, PO, accum, steps, kw.pop("ckpt_every",
                                                              10**9)), **kw)
    params = param_tree(model) if params is None else params
    p, o = tr.run(params, PO.adamw_init(params))
    loader.stop()
    return tr, p, o


def _assert_curves_match(port_log, ref_log):
    assert [r["step"] for r in port_log] == [r["step"] for r in ref_log]
    for got, want in zip(port_log, ref_log):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"],
                                   rtol=GNORM_RTOL)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=LR_RTOL)
    np.testing.assert_allclose(port_log[0]["loss"], ref_log[0]["loss"],
                               rtol=1e-6)


def _assert_params_match(port_params, ref_params, init):
    want = dict(ref_records(ref_params))
    start = dict(ref_records(init))
    for key, t in tree_to_records(port_params):
        ref = np.asarray(want[key]).astype(np.float64)
        moved = np.linalg.norm(ref - np.asarray(start[key]))
        err = np.linalg.norm(t.double().numpy() - ref)
        assert err <= UPDATE_REL * moved + 1e-12, (key, err, moved)


@pytest.mark.parametrize("arch,accum", [("gemma2-9b", 1), ("gemma2-9b", 2),
                                        ("whisper-tiny", 1)])
def test_trainer_matches_the_reference(arch, accum):
    cfg = fp32_config(arch)
    jax_model, params, model = model_pair(cfg)
    ref, ref_p, _ = _ref_run(jax_model, params, cfg, accum)
    port, port_p, port_o = _port_run(model, cfg, accum)
    _assert_curves_match(port.metrics_log, ref.metrics_log)
    _assert_params_match(port_p, ref_p, params)
    assert int(port_o["step"]) == STEPS
    # donated: the module's own weights hold the trained values
    assert torch.equal(model.embed, port_p["embed"])


def test_recovery_from_a_checkpoint_matches_the_reference(tmp_path):
    """A failure at step 3 with ``ckpt_every=2``: both restore step 2's
    checkpoint and replay step 2 on the next batch."""
    cfg = fp32_config("gemma2-9b")
    jax_model, params, model = model_pair(cfg)
    ref_ckpt = RefManager(RefGofer.for_root("ckpt", tmp_path / "ref",
                                            write=True))
    ref, ref_p, _ = _ref_run(
        jax_model, params, cfg, 1, ckpt_every=2, ckpt=ref_ckpt,
        injector=JR.FailureInjector(fail_at={3: ["host1"]}),
        monitor=JR.HeartbeatMonitor(["host0", "host1"]))
    monitor = PR.HeartbeatMonitor(["host0", "host1"])
    ckpt = CheckpointManager(Gofer.for_root("ckpt", tmp_path / "port",
                                            write=True))
    port, port_p, _ = _port_run(
        model, cfg, 1, ckpt_every=2, ckpt=ckpt, monitor=monitor,
        injector=PR.FailureInjector(fail_at={3: ["host1"]}))
    assert port.restarts == ref.restarts == 1
    assert monitor.workers() == ["host0"]
    assert ckpt.all_steps() == ref_ckpt.all_steps() == [2, 4, 5]
    _assert_curves_match(port.metrics_log, ref.metrics_log)
    _assert_params_match(port_p, ref_p, params)


def test_recovered_run_equals_an_uninterrupted_run_one_step_longer(tmp_path, one_thread):
    cfg = fp32_config("gemma2-9b")
    _, _, model = model_pair(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    _, recovered, _ = _port_run(
        model, cfg, 1, ckpt_every=2,
        ckpt=CheckpointManager(Gofer.for_root("ckpt", tmp_path, write=True)),
        injector=PR.FailureInjector(fail_at={3: ["host1"]}))
    model.load_state_dict(start)
    _, straight, _ = _port_run(model, cfg, 1, steps=STEPS + 1)
    for (key, a), (_, b) in zip(tree_to_records(recovered),
                                tree_to_records(straight)):
        assert torch.equal(a, b), key


def test_failure_before_the_first_checkpoint_restarts_from_seed_0(tmp_path, one_thread):
    """The fresh ``init_state(0)`` resumes at step 0 with the loader's
    next batch: the run equals one from seed 0 on batches 1.."""
    cfg = fp32_config("gemma2-9b")
    _, _, model = model_pair(cfg)
    tr, got, _ = _port_run(
        model, cfg, 1, ckpt_every=2,
        ckpt=CheckpointManager(Gofer.for_root("ckpt", tmp_path, write=True)),
        injector=PR.FailureInjector(fail_at={1: ["host0"]}))
    assert tr.restarts == 1
    loader = _dataset(PD, cfg, start=1)
    fresh = PR.Trainer(model, loader, _trainer_cfg(PR, PO, 1))
    params, opt = fresh.init_state(0)
    want, _ = fresh.run(params, opt)
    loader.stop()
    for (key, a), (_, b) in zip(tree_to_records(got), tree_to_records(want)):
        assert torch.equal(a, b), key


def test_failure_without_a_checkpoint_manager_propagates():
    cfg = fp32_config("gemma2-9b")
    _, _, model = model_pair(cfg)
    with pytest.raises(PR.WorkerFailure):
        _port_run(model, cfg, 1,
                  injector=PR.FailureInjector(fail_at={1: ["host0"]}))


def test_stepper_under_the_scheduler_equals_run(one_thread):
    cfg = fp32_config("gemma2-9b")
    _, _, model = model_pair(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    _, want, _ = _port_run(model, cfg, 1)
    model.load_state_dict(start)
    loader = _dataset(PD, cfg)
    tr = PR.Trainer(model, loader, _trainer_cfg(PR, PO, 1))
    params = param_tree(model)
    stepper = tr.stepper(params, PO.adamw_init(params))
    sched = ServerlessScheduler()
    rows = []
    while not stepper.done():
        tid = sched.submit(TaskSpec(tenant="train", fn=system_task(
            lambda: stepper.step_once()), name="train_step"))
        sched.run_pending()
        rec = sched.record(tid)
        assert rec.state is TaskState.SUCCEEDED, rec.error
        rows.append(rec.result.value)
    loader.stop()
    assert [r["step"] for r in rows] == list(range(STEPS))
    assert stepper.remaining() == 0 and stepper.step_once() is None
    for (key, a), (_, b) in zip(tree_to_records(stepper.params),
                                tree_to_records(want)):
        assert torch.equal(a, b), key


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    flags = ["--reduced", "--device", "cpu", "--seq", "32",
             "--global-batch", "4", "--ckpt-dir", str(tmp_path)]
    train_main(flags + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[train] arch=gemma2-9b-smoke" in out and "device=cpu" in out
    losses = [float(x) for x in
              __import__("re").findall(r"\] step +\d+ loss (\S+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "checkpoints: [3]" in out
    train_main(flags + ["--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "checkpoints: [3, 5]" in out


def test_launcher_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])


def test_launcher_fails_whisper_without_frames(tmp_path):
    """The synthetic stream carries no encoder frames (the reference's
    launcher fails there too)."""
    with pytest.raises(KeyError, match="frames"):
        train_main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu",
                    "--steps", "1", "--ckpt-dir", str(tmp_path)])
