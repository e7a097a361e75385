"""Epoch loop (counterpart of ``scouter_tpu/train/loop.py``; the
reference's ``train.py:82-204`` and ``engine.py``).

- one call of the train step per batch (``steps.make_train_step``)
- metrics are summed on the device and fetched once per epoch, where the
  reference syncs with ``.item()`` every batch (``engine.py:36``)
- StepLR sets the epoch's lr before it starts (``train.py:179``)
- checkpoints follow the reference's names and cadence (``core.checkpoint``)
- ``--preempt_save``: on SIGTERM the current train step finishes, a
  checkpoint with the batch cursor and the epoch's running sums is written
  synchronously, and ``fit`` returns; ``--resume`` redoes that epoch from its
  cursor, consuming the batches before it without stepping, so the run ends
  with the parameters an uninterrupted run ends with, bit for bit (the
  JAX package's ``loop.py:113-131, 252-380``). ``--ckpt_async`` writes
  epoch-end checkpoints on a background thread
  (``core.checkpoint.AsyncCheckpointWriter``).
- on a mesh (``--mesh_shape``, ``parallel/``; one process a device under
  ``python -m torch.distributed.run``) each rank loads its data shard, the
  steps average gradients and report the global batch's metrics, so the
  epoch averages are equal on every rank; ``--mesh_shape D,M`` or
  ``--zero1 true`` shards the state (``_place_state``), which needs
  ``--sync_bn true``; checkpoints are gathered on every rank and written by
  rank 0; a preemption stops every rank at the same batch
  (``_stop_consensus``).

The model is built with ``fused_slot=True``: under grad the slot head runs
K1 with hist and its checkpointed gradient, in eval the hist-free build. The
JAX trainer builds ``fused_slot=False`` because XLA fuses the plain slot ops;
eager PyTorch does not, so the port trains through the hand-written kernel.
The numbers are the same: the kernel's forward and gradient equal the plain
loop's.

``compute_dtype='bfloat16'`` trains as the JAX package's Trainer does
(``scouter_tpu/train/loop.py:71-77``): the backbone's convs and BatchNorms
compute in bf16 from f32 master parameters, the slot head (and so K1) and
the loss stay f32, AdamW's state is f32, and checkpoints hold f32 weights.
With ``slot_head_dtype='compute'`` the slot head computes in bf16 too: its
f32 parameters are cast at use, K1 takes bf16 inputs (f32 arithmetic inside)
and returns bf16 gradients, which reach the f32 parameters through the
casts. Where JAX's bf16 head runs in bf16 arithmetic on its jnp path, K1's
gradient is the f32 one rounded once, so it lies closer to float64.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from ..core.checkpoint import (AsyncCheckpointWriter, checkpoint_path, restore_checkpoint,
                               save_checkpoint)
from ..core.config import ScouterConfig, check_training_supported, compute_dtype
from ..core.device import resolve_device
from ..core.distributed import collective_device, get_world_size
from ..data import Loader, select_dataset
from ..models import (build_slot_model, merge_variables, prepare_pretrained_state_dict,
                      strip_prefix)
from ..parallel.mesh import make_mesh
from ..parallel.tp import gather_full, shard_train_state, tp_enabled
from .preempt import PreemptionGuard
from .state import create_train_state, step_lr
from .steps import make_eval_step, make_train_step, set_learning_rate

__all__ = ["MetricLog", "Trainer", "run_training"]

_METRICS = ("loss", "acc", "log_loss", "att_loss")


class MetricLog:
    """record dict parity (tools/calculate_tool.py:18-31)."""

    def __init__(self):
        self.record: Dict[str, Dict[str, List[float]]] = {
            mode: {k: [] for k in _METRICS} for mode in ("train", "val")}

    def append(self, mode: str, metrics: Dict[str, float]) -> None:
        for k in _METRICS:
            self.record[mode][k].append(round(float(metrics[k]), 3))

    def print_metric(self) -> None:
        r = self.record
        print("train loss:", r["train"]["loss"])
        print("val loss:", r["val"]["loss"])
        print("train acc:", r["train"]["acc"])
        print("val acc:", r["val"]["acc"])
        print("train CE loss", r["train"]["log_loss"])
        print("val CE loss", r["val"]["log_loss"])
        print("train attention loss", r["train"]["att_loss"])
        print("val attention loss", r["val"]["att_loss"])


class Trainer:
    """Owns the model, train state, steps and loaders of one config."""

    def __init__(self, cfg: ScouterConfig, mesh=None, datasets=None):
        check_training_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape, cfg.mesh_axes)
        self.model = build_slot_model(cfg, fused_slot=True, device=self.device,
                                      compute_dtype=compute_dtype(cfg))
        if datasets is None:
            datasets = (select_dataset(cfg, train=True), select_dataset(cfg, train=False))
        ds_train, ds_val = datasets
        self.loader_train = Loader(ds_train, cfg.batch_size, img_size=cfg.img_size,
                                   train=True, aug=cfg.aug, seed=cfg.seed, mesh=self.mesh,
                                   device=self.device)
        self.loader_val = Loader(ds_val, cfg.batch_size, img_size=cfg.img_size,
                                 train=False, seed=cfg.seed, mesh=self.mesh, device=self.device)
        if get_world_size() > 1:
            # one start for every rank: rank 0's weights (the init is seeded
            # alike everywhere; this makes it so whatever the device)
            with torch.no_grad():
                for t in self.model.state_dict().values():
                    dist.broadcast(t, src=0)
        self.state = create_train_state(self.model, cfg.lr, freeze_layers=cfg.freeze_layers,
                                        pre_trained=cfg.pre_trained)
        self._place_state()
        self.eval_step = make_eval_step(float(cfg.lambda_value), mesh=self.mesh)
        self.log = MetricLog()
        self.start_epoch = cfg.start_epoch
        self._skip_batches = 0  # a mid-epoch resume's cursor
        self._resume_metric_sums = None  # the interrupted epoch's sums, for the redo
        self._preempted_at = None  # (epoch, train batches done) once the guard fired
        self._preempt_sums = None  # the interrupted epoch's {"sums", "n"}
        self._preempt_exit = False  # the guard fired during val: exit after the epoch
        # the preemption poll's interval in batches on several processes
        # (_stop_consensus); a test of exact stop indices on a tiny epoch sets 1
        self.consensus_every = 8
        self.guard = PreemptionGuard().install() if cfg.preempt_save else None
        self.ckpt_writer = AsyncCheckpointWriter() if cfg.ckpt_async else None

    def _place_state(self) -> None:
        """Tensor parallelism / ZeRO-1 (``parallel/tp.py``): with a ``model``
        axis or ``zero1`` the state keeps this rank's shards, and the train
        step is built for that layout; ``state_shardings`` is None where the
        state is whole."""
        self.state_shardings = None
        if tp_enabled(self.mesh) or self.cfg.zero1:
            if not self.cfg.sync_bn:
                raise ValueError(
                    "tensor parallelism / zero1 requires sync_bn=True (the "
                    "per-replica-BN shard_map path is data-axis-only)")
            self.state, self.state_shardings = shard_train_state(
                self.state, self.mesh, zero1=self.cfg.zero1)
        self.train_step = make_train_step(float(self.cfg.lambda_value), mesh=self.mesh,
                                          sync_bn=self.cfg.sync_bn,
                                          state_shardings=self.state_shardings)

    def _unshard(self) -> None:
        """Gather the model's sharded leaves back into whole tensors (a
        collective), before new weights are loaded over them."""
        sh = self.state.shardings
        if sh is None:
            return
        named = {**dict(self.model.named_parameters()), **dict(self.model.named_buffers())}
        specs = {**sh.params, **sh.buffers}
        with torch.no_grad():
            for name in sh.gathered_names():
                named[name].data = gather_full(named[name].data, specs[name], self.mesh)
        self.state.shardings = None

    def _reset_optimizer(self) -> None:
        """Fresh optimizer state after new weights (``load_variables`` parity),
        re-placed on the mesh's layout."""
        self.state = create_train_state(self.model, self.cfg.lr,
                                        freeze_layers=self.cfg.freeze_layers,
                                        pre_trained=self.cfg.pre_trained)
        self._place_state()

    def _load_backbone(self, sd: Dict[str, torch.Tensor]) -> None:
        """Overlay backbone weights (reference names, no ``backbone.`` prefix);
        entries the backbone lacks or that are absent keep their init."""
        self._unshard()
        self.model.backbone.load_state_dict(
            merge_variables(self.model.backbone.state_dict(), sd))
        self._reset_optimizer()

    def maybe_use_pre(self) -> None:
        """use_pre backbone handoff (``sloter/slot_model.py:26-33``): boot the
        slot model's backbone from the plain no-slot checkpoint of the same
        dataset; the slot head stays fresh."""
        if not (self.cfg.use_slot and self.cfg.use_pre):
            return
        no_slot_cfg = self.cfg.replace(use_slot=False, loss_status=1, cal_area_size=False)
        path = checkpoint_path(self.cfg.output_dir, no_slot_cfg)
        sd = torch.load(path, map_location=self.device, weights_only=True)["model"]
        self._load_backbone({k: v for k, v in strip_prefix(sd, "backbone.").items()
                             if not k.startswith("fc.")})
        print("load pre dataset parameter over")

    # timm default_cfg (first_conv, classifier) names for the local
    # pretrained-weight path, per family whose names are not conv1 / fc
    # (the JAX package's train/loop.py:195-199)
    _PRETRAINED_LAYOUT: Dict[str, Tuple[str, str]] = {
        "efficientnet": ("conv_stem", "classifier"),
        "mobilenet": ("conv_stem", "classifier"),
        "densenet": ("features.conv0", "classifier"),
    }

    def maybe_load_pretrained(self) -> None:
        """``pretrained=True`` without a download (timm helpers.py:68-101): read
        a torch state dict from ``$SCOUTER_TPU_PRETRAINED_DIR/{model}.pth``
        (default ``pretrained/``) into the backbone; a missing file keeps the
        random init. The weights go through ``prepare_pretrained_state_dict``
        with the checkpoint's own class count, so a 1001-class head (an
        extra background class) loses row 0 for a 1000-class model and a
        head of another count is dropped (the slot model has none); for
        MNIST the stem conv is dropped too, which the 1-channel surgery
        replaces."""
        if not self.cfg.pre_trained:
            return
        d = os.environ.get("SCOUTER_TPU_PRETRAINED_DIR", "pretrained")
        path = os.path.join(d, f"{self.cfg.model}.pth")
        if not os.path.isfile(path):
            return
        sd = torch.load(path, map_location=self.device, weights_only=True)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        first_conv, classifier = ("conv1", "fc")
        for key, layout in self._PRETRAINED_LAYOUT.items():
            if key in self.cfg.model:
                first_conv, classifier = layout
        head = sd.get(classifier + ".weight")
        sd = prepare_pretrained_state_dict(
            sd, num_classes=self.cfg.num_classes, first_conv=first_conv, classifier=classifier,
            pretrained_classes=self.cfg.num_classes if head is None else head.shape[0])
        if self.cfg.dataset == "MNIST":
            sd = {k: v for k, v in sd.items() if not k.startswith(first_conv + ".")}
        self._load_backbone(sd)
        print(f"loaded pretrained backbone from {path}")

    def maybe_resume(self) -> None:
        if self.cfg.resume:
            path = checkpoint_path(self.cfg.output_dir, self.cfg)
            # a sharded state is cut back onto its layout
            self.state, epoch, _, batch, extras = restore_checkpoint(
                path, self.state, shardings=self.state_shardings, return_batch=True,
                return_extras=True)
            if batch is not None:
                # a preemption checkpoint: redo epoch `epoch` from its cursor
                self.start_epoch = epoch
                self._skip_batches = batch
                self._resume_metric_sums = extras.get("metric_sums")
                print(f"resumed from {path} at epoch {epoch}, batch {batch}")
            else:
                self.start_epoch = epoch + 1
                print(f"resumed from {path} at epoch {epoch}")

    def _stop_consensus(self, bi: int) -> bool:
        """Whether to stop after batch ``bi``, the same answer on every rank.

        A SIGTERM reaches each rank at its own time; a rank that stopped alone
        would wait in the checkpoint's gathering while the others wait in the
        step's collectives. So the ranks max-reduce their guards' flags and
        all stop at the same batch, and checkpoint the same cursor. They poll
        every ``consensus_every`` batches (every rank at the same ``bi``), not
        every batch; one process answers its own flag at once."""
        local = self.guard is not None and self.guard.triggered
        if self.guard is None or get_world_size() == 1:
            return local
        if (bi + 1) % self.consensus_every:
            return False
        flag = torch.tensor([int(local)], dtype=torch.int32, device=collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def run_epoch(self, epoch: int, mode: str) -> Dict[str, float]:
        loader = self.loader_train if mode == "train" else self.loader_val
        sums, n = None, 0
        # a mid-epoch resume consumes the batches before its cursor without
        # stepping, and carries the interrupted epoch's sums (f32 values, so
        # the sums go on as the uninterrupted run's do)
        skip = self._skip_batches if mode == "train" else 0
        self._skip_batches = 0
        restored = self._resume_metric_sums if mode == "train" and skip else None
        self._resume_metric_sums = None
        if restored is not None:
            sums = torch.tensor([restored["sums"][k] for k in _METRICS], device=self.device)
            n = int(restored["n"])
        print(f"start {mode} :{epoch}")
        for bi, batch in enumerate(loader.epoch(epoch)):
            if bi < skip:
                continue
            if mode == "train":
                self.state, metrics = self.train_step(self.state, batch)
            else:
                metrics = self.eval_step(self.state, batch)
            stacked = torch.stack([metrics[k] for k in _METRICS])
            sums = stacked if sums is None else sums + stacked
            n += 1
            if self.guard is not None and self._stop_consensus(bi):
                if mode == "train":
                    self._preempted_at = (epoch, bi + 1)
                    self._preempt_sums = {"sums": dict(zip(_METRICS, sums.tolist())), "n": n}
                else:
                    self._preempt_exit = True  # the epoch-end checkpoint exists
                break
        values = sums.tolist() if sums is not None else [0.0] * len(_METRICS)
        avg = {k: v / max(n, 1) for k, v in zip(_METRICS, values)}
        self.log.append(mode, avg)
        return avg

    def _preempt_checkpoint(self) -> None:
        """Write the preemption checkpoint synchronously, after the writer's
        pending epoch-end writes."""
        epoch, done = self._preempted_at
        if not self.cfg.output_dir:
            print(f"[preempt] no output_dir: exiting at epoch {epoch}, batch {done} WITHOUT a "
                  "checkpoint")
            return
        if self.ckpt_writer is not None:
            self.ckpt_writer.drain()
        save_checkpoint(self.cfg.output_dir, self.cfg, self.state, epoch, batch=done,
                        metric_sums=self._preempt_sums)
        print(f"[preempt] checkpointed epoch {epoch} at batch {done}; exiting")

    def fit(self) -> List[float]:
        cfg = self.cfg
        self.maybe_load_pretrained()
        self.maybe_use_pre()
        self.maybe_resume()
        start = time.time()
        try:
            for epoch in range(self.start_epoch, cfg.epochs):
                # StepLR: epoch e runs at lr * gamma^(e // lr_drop)
                set_learning_rate(self.state, step_lr(cfg.lr, epoch, cfg.lr_drop))
                self.run_epoch(epoch, "train")
                if self._preempted_at is not None:
                    self._preempt_checkpoint()
                    break
                if cfg.output_dir:
                    save_checkpoint(cfg.output_dir, cfg, self.state, epoch,
                                    writer=self.ckpt_writer)
                self.run_epoch(epoch, "val")
                self.log.print_metric()
                if self._preempt_exit:
                    print(f"[preempt] exiting after the interrupted val epoch {epoch} (its "
                          "epoch-end checkpoint is written)")
                    break
            if self.ckpt_writer is not None:
                self.ckpt_writer.drain()
        finally:
            if self.guard is not None:
                self.guard.uninstall()
        print(f"Training time {time.time() - start:.1f}s")
        r = self.log.record
        return [r["train"]["acc"][-1] if r["train"]["acc"] else 0.0,
                r["val"]["acc"][-1] if r["val"]["acc"] else 0.0]


def run_training(cfg: ScouterConfig, datasets=None) -> List[float]:
    """main(args) equivalent: returns [last train acc, last val acc]
    (train.py:204)."""
    return Trainer(cfg, datasets=datasets).fit()
