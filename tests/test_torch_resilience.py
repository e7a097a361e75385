"""Graceful preemption with an exact mid-epoch resume, and async checkpoint
writing, in the port on the CPU: ``tests/test_resilience.py``'s cases for
``scouter_tpu_torch``, plus a real SIGTERM through ``--preempt_save``.

The Loader is deterministic per (seed, epoch, batch index), so a preemption
checkpoint that records the completed batches resumes to the parameters an
uninterrupted run ends with, bit for bit. The last case holds the port's
Loader to the JAX package's for the batches a resume runs, without
building a JAX Trainer (its CPU compile takes minutes)."""

import os
import signal

import numpy as np
import pytest
import torch

from scouter_tpu.data import ArrayDataset as JaxArrayDataset
from scouter_tpu.data import Loader as JaxLoader
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.core.checkpoint import (AsyncCheckpointWriter, checkpoint_path,
                                               restore_checkpoint, save_checkpoint)
from scouter_tpu_torch.data import ArrayDataset, Loader, synthetic_mnist
from scouter_tpu_torch.train import Trainer
from scouter_tpu_torch.train import loop as train_loop
from scouter_tpu_torch.train.preempt import PreemptionGuard


def small_cfg(**kw):
    base = dict(model="resnet10", dataset="MNIST", num_classes=10, channel=512,
                use_slot=True, slots_per_class=1, power=1, loss_status=1, to_k_layer=1,
                lambda_value=1.0, img_size=32, batch_size=8, epochs=2, lr=1e-3,
                pre_trained=False, freeze_layers=0, output_dir="", seed=0, device="cpu")
    base.update(kw)
    return ScouterConfig(**base)


def make_datasets():
    (tr_x, tr_y), (te_x, te_y) = synthetic_mnist(num_train=48, num_test=16)
    return ArrayDataset(tr_x, tr_y, "MNIST"), ArrayDataset(te_x, te_y, "MNIST")


class TriggerAfterSteps:
    """A PreemptionGuard whose signal arrives after N completed train steps
    (the loop polls ``triggered`` once per step)."""

    def __init__(self, n):
        self.n = n
        self.polls = 0

    @property
    def triggered(self):
        self.polls += 1
        return self.polls >= self.n

    def uninstall(self):
        pass


@pytest.fixture(scope="module")
def uninterrupted():
    """A Trainer that ran two epochs without an interruption."""
    t = Trainer(small_cfg(), datasets=make_datasets())
    t.fit()
    return t


def assert_same_state(a: Trainer, b: Trainer):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    sa, sb = a.state.optimizer.state_dict()["state"], b.state.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sa[k][key], sb[k][key], rtol=0, atol=0)
    assert a.state.step == b.state.step


class TestPreemptionGuard:
    def test_signal_sets_flag_and_restores_handler(self):
        prev = signal.getsignal(signal.SIGTERM)
        guard = PreemptionGuard().install()
        assert not guard.triggered
        signal.raise_signal(signal.SIGTERM)
        assert guard.triggered
        guard.uninstall()
        assert signal.getsignal(signal.SIGTERM) is prev

    def test_programmatic_trigger(self):
        guard = PreemptionGuard()
        guard.trigger()
        assert guard.triggered


class TestMidEpochResume:
    def test_preempt_resume_bitwise_equal(self, tmp_path, uninterrupted):
        """Interrupted after 3 train steps of epoch 0, resumed, 2 epochs in
        all: parameters, AdamW state and step count equal the uninterrupted
        run's bit for bit, and so does the logged train average."""
        datasets = make_datasets()
        cfg = small_cfg(output_dir=str(tmp_path))
        t1 = Trainer(cfg, datasets=datasets)
        t1.guard = TriggerAfterSteps(3)
        t1.fit()
        assert t1._preempted_at == (0, 3)
        _, epoch, _, batch = restore_checkpoint(
            checkpoint_path(str(tmp_path), cfg), Trainer(small_cfg(), datasets=datasets).state,
            return_batch=True)
        assert (epoch, batch) == (0, 3)

        t2 = Trainer(cfg.replace(resume=True), datasets=datasets)
        t2.fit()
        assert t2._preempted_at is None
        assert_same_state(uninterrupted, t2)
        assert t2.log.record["train"] == uninterrupted.log.record["train"]
        assert t2.log.record["val"] == uninterrupted.log.record["val"]

    def test_real_sigterm_preempts_and_resumes(self, tmp_path, uninterrupted, monkeypatch,
                                               capsys):
        """``--preempt_save``: a real SIGTERM after train step 5 of epoch 0
        checkpoints (0, 5) and returns; ``--resume`` ends where the
        uninterrupted run ends."""
        make_step = train_loop.make_train_step

        def signalling_step(lam, **kw):  # the Trainer passes its mesh too
            step, calls = make_step(lam, **kw), []

            def wrapped(state, batch):
                out = step(state, batch)
                calls.append(1)
                if len(calls) == 5:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out
            return wrapped

        datasets = make_datasets()
        cfg = small_cfg(output_dir=str(tmp_path), preempt_save=True)
        prev = signal.getsignal(signal.SIGTERM)
        monkeypatch.setattr(train_loop, "make_train_step", signalling_step)
        t1 = Trainer(cfg, datasets=datasets)
        t1.fit()
        monkeypatch.undo()
        assert signal.getsignal(signal.SIGTERM) is prev
        out = capsys.readouterr().out
        assert "[preempt] caught signal" in out
        assert "[preempt] checkpointed epoch 0 at batch 5; exiting" in out
        assert t1._preempted_at == (0, 5)
        t2 = Trainer(cfg.replace(resume=True), datasets=datasets)
        t2.fit()
        assert "resumed from" in capsys.readouterr().out
        assert_same_state(uninterrupted, t2)

    def test_epoch_boundary_save_has_no_cursor(self, tmp_path):
        cfg = small_cfg(epochs=1, output_dir=str(tmp_path))
        t = Trainer(cfg, datasets=make_datasets())
        t.fit()
        _, epoch, _, batch, extras = restore_checkpoint(
            checkpoint_path(str(tmp_path), cfg), t.state, return_batch=True,
            return_extras=True)
        assert epoch == 0 and batch is None and extras == {}

    def test_sigterm_during_val_exits_after_the_epoch(self, tmp_path):
        datasets = make_datasets()
        cfg = small_cfg(output_dir=str(tmp_path), preempt_save=True)
        t = Trainer(cfg, datasets=datasets)
        t.guard.uninstall()
        t.guard = TriggerAfterSteps(len(datasets[0]) // cfg.batch_size + 1)  # val batch 1
        t.fit()
        assert t._preempted_at is None and t._preempt_exit
        assert len(t.log.record["train"]["loss"]) == 1  # epoch 1 never ran
        _, epoch, _, batch = restore_checkpoint(checkpoint_path(str(tmp_path), cfg), t.state,
                                                return_batch=True)
        assert (epoch, batch) == (0, None)


class TestAsyncCheckpointWriter:
    def test_async_bytes_identical_to_sync(self, tmp_path):
        cfg = small_cfg(epochs=1)
        t = Trainer(cfg, datasets=make_datasets())
        t.run_epoch(0, "train")
        sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
        save_checkpoint(str(sync_dir), cfg, t.state, epoch=0)
        w = AsyncCheckpointWriter()
        save_checkpoint(str(async_dir), cfg, t.state, epoch=0, writer=w)
        w.close()
        name = os.path.basename(checkpoint_path(str(sync_dir), cfg))
        assert (sync_dir / name).read_bytes() == (async_dir / name).read_bytes()

    def test_writer_error_surfaces_at_drain(self):
        w = AsyncCheckpointWriter()

        def boom():
            raise RuntimeError("disk full")

        w.submit(boom)
        with pytest.raises(RuntimeError, match="disk full"):
            w.drain()
        w.close()
        assert not w._thread.is_alive()

    def test_trainer_ckpt_async_roundtrips(self, tmp_path):
        datasets = make_datasets()
        cfg = small_cfg(epochs=1, output_dir=str(tmp_path), ckpt_async=True)
        t = Trainer(cfg, datasets=datasets)
        t.fit()
        restored = Trainer(cfg, datasets=datasets)
        restored.state, epoch, _ = restore_checkpoint(checkpoint_path(str(tmp_path), cfg),
                                                      restored.state)
        assert epoch == 0
        torch.testing.assert_close(restored.model.slot.initial_slots,
                                   t.model.slot.initial_slots, rtol=0, atol=0)
        assert_same_state(t, restored)


def test_resume_batches_equal_jax_loader():
    """For the cursor (0, 3), the batches a resume runs hold the same sample
    indices in the port's Loader and in the JAX package's (labels are the
    indices here), in epoch 0's rest and in epoch 1."""
    n, bs = 45, 8
    images = np.random.RandomState(0).randint(0, 256, (n, 6, 6, 1)).astype(np.uint8)
    labels = np.arange(n, dtype=np.int32)
    ours = Loader(ArrayDataset(images, labels, "MNIST"), bs, img_size=6, train=True, seed=0,
                  device="cpu")
    theirs = JaxLoader(JaxArrayDataset(images, labels, "MNIST"), bs, img_size=6, train=True,
                       seed=0, shard_by_host=False)
    for epoch, skip in ((0, 3), (1, 0)):
        got = [b["label"] for b in ours._host_batches(epoch)][skip:]
        want = [b["label"] for b in theirs._host_batches(epoch)][skip:]
        assert len(got) == len(want) == n // bs - skip
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
