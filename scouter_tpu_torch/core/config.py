"""Experiment configuration with the reference CLI's flag names
(counterpart of ``scouter_tpu/core/config.py``).

Every flag of the JAX package's parser is accepted with the same name and
default, including the reference's string-typed sweepable flags
(``num_classes``, ``lambda_value``, ``power``, ``slots_per_class``), which
:func:`config_from_args` coerces to scalars, and ``--mesh_shape``, parsed as
the JAX package parses it. ``device`` is ``cuda`` (the default) or ``cpu``,
which :func:`check_serving_supported` and :func:`check_training_supported`
hold to; the mesh flags are the Trainer's (``train/loop.py``), and serving
ignores them, as the JAX package's does.
:func:`expand_sweep` is the reference's sweep over comma lists
(``train.py:207-230``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Iterator, Optional, Tuple

__all__ = ["ScouterConfig", "check_serving_supported", "check_training_supported",
           "checkpoint_name", "compute_dtype", "config_from_args", "expand_sweep",
           "get_args_parser", "str2bool"]

_SWEEPABLE = ("num_classes", "lambda_value", "power", "slots_per_class")
_SWEEP_TYPES = (int, float, int, int)
DEVICES = ("cuda", "cpu")


def str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Unsupported value encountered.")


@dataclasses.dataclass
class ScouterConfig:
    # model / dataset
    model: str = "resnet18"
    dataset: str = "MNIST"
    channel: int = 512

    # training
    lr: float = 1e-4
    lr_drop: int = 70
    batch_size: int = 64
    weight_decay: float = 1e-4
    epochs: int = 10
    num_classes: int = 10
    img_size: int = 260
    pre_trained: bool = True
    use_slot: bool = True
    use_pre: bool = False
    aug: bool = False
    grad: bool = False
    grad_min_level: float = 0.0
    iterated_evaluation_num: int = 1
    cal_area_size: bool = False
    thop: bool = False

    # slot settings
    loss_status: int = 1
    freeze_layers: int = 2
    hidden_dim: int = 64
    slots_per_class: int = 3
    power: int = 2
    to_k_layer: int = 1
    lambda_value: float = 1.0
    vis: bool = False
    vis_id: int = 0

    # data / machine
    dataset_dir: str = "data/"
    output_dir: str = "saved_model/"
    pre_dir: str = "pre_model/"
    device: str = "cuda"
    num_workers: int = 4
    start_epoch: int = 0
    resume: bool = False

    # parallelism (parallel/), bf16 compute, and resilience
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("data",)
    sync_bn: bool = True
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # 'float32' keeps the slot head (conv1x1 + xSlot) in f32 under a bf16
    # backbone; 'compute' follows compute_dtype
    slot_head_dtype: str = "float32"
    zero1: bool = False
    preempt_save: bool = False
    ckpt_async: bool = False
    seed: int = 0

    def replace(self, **kw) -> "ScouterConfig":
        return dataclasses.replace(self, **kw)

    @property
    def feature_size(self) -> int:
        # densenet backbones give an 8x8 map at 260px, others 9x9
        return 8 if "densenet" in self.model else 9


def get_args_parser() -> argparse.ArgumentParser:
    """Argparse schema with the reference's flag names and defaults."""
    p = argparse.ArgumentParser("Set SCOUTER model (PyTorch/CUDA port)", add_help=False)
    p.add_argument("--model", default="resnet18", type=str)
    p.add_argument("--dataset", default="MNIST", type=str)
    p.add_argument("--channel", default=512, type=int)

    p.add_argument("--lr", default=0.0001, type=float)
    p.add_argument("--lr_drop", default=70, type=int)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--weight_decay", default=0.0001, type=float)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--num_classes", default="10", type=str)  # sweepable
    p.add_argument("--img_size", default=260, type=int)
    p.add_argument("--pre_trained", default=True, type=str2bool)
    p.add_argument("--use_slot", default=True, type=str2bool)
    p.add_argument("--use_pre", default=False, type=str2bool)
    p.add_argument("--aug", default=False, type=str2bool)
    p.add_argument("--grad", default=False, type=str2bool)
    p.add_argument("--grad_min_level", default=0.0, type=float)
    p.add_argument("--iterated_evaluation_num", default=1, type=int)
    p.add_argument("--cal_area_size", default=False, type=str2bool)
    p.add_argument("--thop", default=False, type=str2bool)

    p.add_argument("--loss_status", default=1, type=int)
    p.add_argument("--freeze_layers", default=2, type=int)
    p.add_argument("--hidden_dim", default=64, type=int)
    p.add_argument("--slots_per_class", default="3", type=str)  # sweepable
    p.add_argument("--power", default="2", type=str)  # sweepable
    p.add_argument("--to_k_layer", default=1, type=int)
    p.add_argument("--lambda_value", default="1.", type=str)  # sweepable
    p.add_argument("--vis", default=False, type=str2bool)
    p.add_argument("--vis_id", default=0, type=int)

    p.add_argument("--dataset_dir", default="data/")
    p.add_argument("--output_dir", default="saved_model/")
    p.add_argument("--pre_dir", default="pre_model/")
    p.add_argument("--device", default="cuda", choices=DEVICES)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--resume", default=False, type=str2bool)

    p.add_argument("--mesh_shape", default=None, type=str,
                   help="comma list, e.g. '8' or '4,2' (data[,model])")
    p.add_argument("--sync_bn", default=True, type=str2bool,
                   help="True: global-batch BN stats; False: per-replica BN "
                        "(reference DDP semantics)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the backbone's compute dtype; parameters stay float32 in training")
    p.add_argument("--slot_head_dtype", default="float32", choices=["float32", "compute"],
                   help="keep the slot head f32 under a bf16 backbone (default) "
                        "or follow compute_dtype")
    p.add_argument("--zero1", default=False, type=str2bool,
                   help="shard optimizer state over the data mesh axis (ZeRO-1)")
    p.add_argument("--preempt_save", default=False, type=str2bool,
                   help="on SIGTERM finish the step, checkpoint with the batch cursor and "
                        "exit; --resume true continues from exactly that step")
    p.add_argument("--ckpt_async", default=False, type=str2bool,
                   help="write epoch-end checkpoints on a background thread")
    p.add_argument("--seed", default=0, type=int)
    return p


def expand_sweep(ns: argparse.Namespace) -> Iterator[Tuple[Optional[str], ScouterConfig]]:
    """param_translation parity (``train.py:207-230``).

    Yields (sweep_key or None, resolved config). A comma list in one of the
    sweepable flags gives one config per value; the reference sweeps only
    the first such flag, in ``_SWEEPABLE`` order."""
    raw = {k: str(getattr(ns, k)) for k in _SWEEPABLE}
    target = None
    for name, typ in zip(_SWEEPABLE, _SWEEP_TYPES):
        if target is None and raw[name].find(",") > 0:
            target = (name, typ, raw[name].split(","))
        else:
            setattr(ns, name, typ(raw[name]))

    if target is None:
        yield None, config_from_args(ns)
        return

    name, typ, values = target
    for v in values:
        setattr(ns, name, typ(v))
        yield f"{name}-{v}", config_from_args(ns)


def config_from_args(ns: argparse.Namespace) -> ScouterConfig:
    fields = {f.name for f in dataclasses.fields(ScouterConfig)}
    kw = {k: v for k, v in vars(ns).items() if k in fields}
    for name, typ in zip(_SWEEPABLE, _SWEEP_TYPES):
        if name in kw and isinstance(kw[name], str):
            kw[name] = typ(kw[name])
    if isinstance(kw.get("mesh_shape"), str):
        kw["mesh_shape"] = tuple(int(s) for s in kw["mesh_shape"].split(","))
    return ScouterConfig(**kw)


def check_serving_supported(cfg: ScouterConfig) -> None:
    """Raise for a device the port does not know."""
    if cfg.device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {cfg.device!r}")


def check_training_supported(cfg: ScouterConfig) -> None:
    """Raise for a device the port does not know. The mesh flags are checked
    where the JAX package checks them: the mesh against the world in
    ``parallel/mesh.py::make_mesh``, TP and ZeRO-1 against ``sync_bn`` in
    the Trainer. A bf16 slot head (``--slot_head_dtype compute`` under
    ``--compute_dtype bfloat16``) trains; ``float32`` stays the default, for
    the JAX package's reason (``scouter_tpu/core/config.py:92-97``)."""
    check_serving_supported(cfg)


def compute_dtype(cfg: ScouterConfig):
    """The torch dtype of ``cfg.compute_dtype`` for a training build, or None
    for float32 (the parameters' own)."""
    import torch

    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def checkpoint_name(cfg: ScouterConfig, epoch: Optional[int] = None) -> str:
    """The reference's config-derived checkpoint name (``train.py:181-196``)."""
    name = f"{cfg.dataset}_"
    name += "use_slot_" if cfg.use_slot else "no_slot_"
    if cfg.use_slot and cfg.loss_status != 1:
        name += "negative_"
    if cfg.cal_area_size:
        name += f"for_area_size_{cfg.lambda_value}_{cfg.slots_per_class}_"
    if epoch is None:
        return name + "checkpoint"
    return name + f"checkpoint{epoch:04d}"
