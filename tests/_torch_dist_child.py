"""One rank of the gloo world that tests/test_torch_distributed.py starts.

Usage: python _torch_dist_child.py <port> <rank> <world> <workdir>

Imports torch and the port only (no JAX). Reads the weights and global
batches the test wrote to ``<workdir>``, and runs, every rank in step:

- data-parallel train steps over a (4,) mesh in both BN modes, on this
  rank's rows of each global batch, and with per-replica BN in float64;
- train steps over a (2, 2) mesh with ZeRO-1, a checkpoint of that sharded
  state (gathered on every rank, written by rank 0), and its restore back
  onto the layout, which must give this rank's shards bit for bit;
- ``sync_batch_stats`` over the mesh's data group and over the world;
- ``save_on_master`` to a file named after the rank;
- the Trainer on the (2, 2) mesh with ZeRO-1: an uninterrupted run, a run
  whose rank 1 alone sees its preemption guard fire, which every rank must
  stop on at the same batch and checkpoint, and the resume of that run,
  whose final state must equal the uninterrupted run's bit for bit.

Rank 0 saves the tensors the test compares with JAX's and the one-process
port; every rank writes ``result_<rank>.json``.
"""

import json
import os
import sys

port, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                  MASTER_ADDR="localhost", MASTER_PORT=port)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from scouter_tpu_torch.core import ScouterConfig  # noqa: E402
from scouter_tpu_torch.core.checkpoint import (checkpoint_path, full_state_dicts,  # noqa: E402
                                               restore_checkpoint, save_checkpoint,
                                               save_on_master)
from scouter_tpu_torch.core.distributed import get_world_size, init_distributed_mode  # noqa: E402
from scouter_tpu_torch.data import ArrayDataset  # noqa: E402
from scouter_tpu_torch.models import build_slot_model  # noqa: E402
from scouter_tpu_torch.parallel import make_mesh, shard_batch, shard_train_state  # noqa: E402
from scouter_tpu_torch.parallel.tp import local_slices  # noqa: E402
from scouter_tpu_torch.train import Trainer, create_train_state, make_train_step  # noqa: E402
from scouter_tpu_torch.train.state import sync_batch_stats  # noqa: E402

init_distributed_mode(device="cpu", timeout=240)
assert get_world_size() == world == 4
import torch.distributed as dist  # noqa: E402

spec = json.load(open(os.path.join(work, "spec.json")))
cfg = ScouterConfig(**spec["cfg"], device="cpu")
weights = torch.load(os.path.join(work, "weights.pt"))
inputs = np.load(os.path.join(work, "inputs.npz"))
batches = [{"image": torch.from_numpy(np.ascontiguousarray(inputs[f"x{i}"])),
            "label": torch.from_numpy(inputs[f"y{i}"]).long()}
           for i in range(spec["steps"])]
result = {}


def port_state(dtype=torch.float32):
    model = build_slot_model(cfg, fused_slot=True, device="cpu").to(dtype)
    model.load_state_dict(weights)
    return create_train_state(model, spec["lr"])


def checksum(sd):
    return float(sum(np.abs(v.double().numpy()).sum() for v in sd.values()
                     if v.is_floating_point()))


def first_grads(state):
    """The averaged gradient this rank holds after a step, each piece with its
    block of the full tensor: the parameter's own gradient, or under ZeRO-1
    the slice its optimizer leaf stepped on."""
    sh = state.shardings
    out = {}
    for name, p in state.model.named_parameters():
        spec = sh.params[name] if sh is not None else ()
        grad = p.grad
        if sh is not None:
            for q, leaf, z in sh.leaves:
                if q is p and z is not None:
                    spec, grad = sh.moments[name], leaf.grad
        if grad is None:
            continue
        full = weights[name].shape
        block = local_slices(full, spec, state.shardings.mesh) if spec else ()
        out[name] = {"grad": grad.clone(),
                     "block": [[b.start or 0, b.stop or n] for b, n in zip(block, full)]
                     if block else [[0, n] for n in full]}
    return out


def run_steps(mesh, state, dtype=torch.float32, **kw):
    """The train steps on this rank's rows; returns the state, each step's
    metrics, the first step's gradients and the model's state after it."""
    step = make_train_step(1.0, mesh=mesh, **kw)
    metrics = []
    for i, batch in enumerate(batches):
        rows = shard_batch(mesh, batch)
        state, m = step(state, {**rows, "image": rows["image"].to(dtype)})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = first_grads(state)
            after_first = {k: v.clone() for k, v in state.model.state_dict().items()}
    return state, metrics, grads, after_first


# ---- data parallel over (4,), both BN modes
mesh4 = make_mesh((4,))
for sync_bn in (True, False):
    state, metrics, grads, after_first = run_steps(mesh4, port_state(), sync_bn=sync_bn)
    sd = state.model.state_dict()
    result[f"dp_{sync_bn}"] = {"metrics": metrics, "checksum": checksum(sd)}
    if rank == 0:
        torch.save({"metrics": metrics, "model": sd, "grads": grads,
                     "after_first": after_first}, os.path.join(work, f"dp_{sync_bn}.pt"))
# per-replica BN in float64, for JAX's float64 mesh step
state, metrics, _, _ = run_steps(mesh4, port_state(torch.float64), torch.float64, sync_bn=False)
if rank == 0:
    torch.save({"metrics": metrics, "model": state.model.state_dict()},
               os.path.join(work, "dp_f64.pt"))

# ---- (2, 2) with ZeRO-1: steps, a sharded checkpoint and its restore
mesh22 = make_mesh((2, 2), ("data", "model"))
state, sh = shard_train_state(port_state(), mesh22, zero1=True)
state, metrics, grads, _ = run_steps(mesh22, state, sync_bn=True, state_shardings=sh)
torch.save(grads, os.path.join(work, f"zero1_grads_{rank}.pt"))
model_sd, opt_sd = full_state_dicts(state)
result["zero1"] = {
    "metrics": metrics, "checksum": checksum(model_sd),
    "coords": mesh22.coords(),
    "local_shapes": {k: list(v.shape) for k, v in state.model.state_dict().items()},
    "moment_shapes": {str(i): list(s["exp_avg"].shape)
                      for i, s in state.optimizer.state_dict()["state"].items()}}
if rank == 0:
    torch.save({"metrics": metrics, "model": model_sd, "optimizer": opt_sd},
               os.path.join(work, "zero1.pt"))
ckpt_dir = os.path.join(work, "ckpt")
save_checkpoint(ckpt_dir, cfg, state, 0)
dist.barrier()
fresh, _ = shard_train_state(port_state(), mesh22, zero1=True)
fresh, epoch, _ = restore_checkpoint(checkpoint_path(ckpt_dir, cfg), fresh,
                                     shardings=fresh.shardings)
live, back = state.model.state_dict(), fresh.model.state_dict()
same = all(torch.equal(live[k], back[k]) for k in live)
live_opt, back_opt = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
same = same and all(torch.equal(live_opt[i][k], back_opt[i][k])
                    for i in live_opt for k in ("exp_avg", "exp_avg_sq"))
same = same and all(torch.equal(a, b) for (_, a, _), (_, b, _) in zip(sh.leaves,
                                                                      fresh.shardings.leaves))
result["restore_equal"] = bool(same)
result["restore_epoch"] = epoch

# ---- timm's distribute_bn: the replicas' BatchNorm statistics averaged
stats_state = port_state()
with torch.no_grad():
    for b in stats_state.model.buffers():
        if b.is_floating_point():
            b.fill_(float(rank))
averaged = []
for mesh in (mesh4, None):
    sync_batch_stats(stats_state, mesh)
    averaged.append(sorted({float(v) for b in stats_state.model.buffers()
                            if b.is_floating_point() for v in b.unique()}))
result["sync_batch_stats"] = averaged

# ---- only rank 0 writes
save_on_master({"rank": rank}, os.path.join(work, f"only_rank{rank}.pth"))

# ---- preemption consensus and resume, through the Trainer
rng = np.random.RandomState(5)
tcfg = cfg.replace(**spec["trainer"])
ds_train = ArrayDataset(rng.randint(0, 256, (16, 32, 32, 1)).astype(np.uint8),
                        rng.randint(0, 3, 16), "MNIST")
ds_val = ArrayDataset(rng.randint(0, 256, (6, 32, 32, 1)).astype(np.uint8),
                      rng.randint(0, 3, 6), "MNIST")
full = Trainer(tcfg.replace(output_dir=os.path.join(work, "run_full")), mesh=mesh22,
               datasets=(ds_train, ds_val))
full.fit()
want_model, want_opt = full_state_dicts(full.state)
cut_dir = os.path.join(work, "run_cut")
cut = Trainer(tcfg.replace(output_dir=cut_dir, preempt_save=True), mesh=mesh22,
              datasets=(ds_train, ds_val))
cut.consensus_every = 1
fire = spec["fire"]  # (epoch, batch index) at which rank 1's guard fires
inner = cut.train_step
steps_per_epoch = cut.loader_train.steps_per_epoch()


def step_then_fire(state, batch):
    out = inner(state, batch)
    if rank == 1 and state.step == fire[0] * steps_per_epoch + fire[1] + 1:
        cut.guard.trigger()
    return out


cut.train_step = step_then_fire
cut.fit()
result["preempted_at"] = list(cut._preempted_at)
result["steps_per_epoch"] = steps_per_epoch
resumed = Trainer(tcfg.replace(output_dir=cut_dir, resume=True), mesh=mesh22,
                  datasets=(ds_train, ds_val))
resumed.fit()
got_model, got_opt = full_state_dicts(resumed.state)
result["resume_start_epoch"] = resumed.start_epoch
result["resume_equal"] = (all(torch.equal(want_model[k], got_model[k]) for k in want_model)
                          and all(torch.equal(want_opt["state"][i][k], got_opt["state"][i][k])
                                  for i in want_opt["state"] for k in ("exp_avg", "exp_avg_sq")))
result["resume_losses"] = [full.log.record["train"]["loss"], resumed.log.record["train"]["loss"]]
# new backbone weights under the layout (the pretrained and use_pre paths):
# gathered, loaded whole, cut again, with a fresh optimizer
shards = {k: v.clone() for k, v in resumed.model.state_dict().items()}
resumed._load_backbone({k[len("backbone."):]: v for k, v in got_model.items()
                        if k.startswith("backbone.")})
result["reloaded_equal"] = (all(torch.equal(shards[k], v)
                                for k, v in resumed.model.state_dict().items())
                            and resumed.state.optimizer.state_dict()["state"] == {}
                            and resumed.state.shardings is resumed.state_shardings)
result["run_files"] = sorted(os.listdir(cut_dir))

with open(os.path.join(work, f"result_{rank}.json"), "w") as f:
    json.dump(result, f)
dist.barrier()
dist.destroy_process_group()
sys.stdout.write("OK\n")  # non-master prints are silenced
