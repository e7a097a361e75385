"""The port's mesh and partition rules against the JAX package's, in one
process on the CPU: ``parallel/tp.py``'s spec of every parameter, BatchNorm
statistic and AdamW moment of resnet10 + xSlot and of the flagship resnest26d
+ xSlot at meshes (2, 4), (4, 2) and (8,), with and without ZeRO-1, held
element for element to ``scouter_tpu.parallel.tp.train_state_shardings`` on
this process's 8 virtual devices through the weight carrier; ``make_mesh``'s
errors and ``host_shard_bounds``; and each rank's Loader batches against
JAX's multi-process Loader. Models are built with ``jax.eval_shape`` and on
torch's meta device."""

import functools

import jax
import numpy as np
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.data import ArrayDataset as JaxArrayDataset
from scouter_tpu.data import Loader as JaxLoader
from scouter_tpu.models import build_slot_model as jax_build_slot_model
from scouter_tpu.parallel import host_shard_bounds as jax_host_shard_bounds
from scouter_tpu.parallel import make_mesh as jax_make_mesh
from scouter_tpu.parallel import train_state_shardings as jax_train_state_shardings
from scouter_tpu.train.state import create_train_state as jax_create_train_state
from scouter_tpu_torch.core import ScouterConfig, distributed
from scouter_tpu_torch.data import ArrayDataset, Loader
from scouter_tpu_torch.models import build_slot_model, variables_to_state_dict
from scouter_tpu_torch.parallel import (host_shard_bounds, make_mesh, shard_batch,
                                        train_state_shardings)
from scouter_tpu_torch.parallel.tp import local_slices, torch_spec
from scouter_tpu_torch.train import create_train_state

MODELS = {
    "resnet10": dict(model="resnet10", dataset="MNIST", num_classes=3, channel=512,
                     slots_per_class=2, to_k_layer=2, hidden_dim=64, img_size=64),
    "flagship": dict(model="resnest26d", dataset="ImageNet", num_classes=10, channel=2048,
                     slots_per_class=3, to_k_layer=3, hidden_dim=64, img_size=64),
}
MESHES = [(2, 4), (4, 2), (8,)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(path):
    return [getattr(k, "key", getattr(k, "name", None)) for k in path]


@functools.lru_cache(maxsize=None)
def layouts(model_name: str):
    """JAX's abstract train state, the port's meta-device model and state,
    and for each JAX leaf (params, batch_stats) its torch name."""
    kw = MODELS[model_name]
    jmodel = jax_build_slot_model(JaxConfig(**kw))
    chans = 1 if kw["dataset"] == "MNIST" else 3
    x = jax.ShapeDtypeStruct((1, kw["img_size"], kw["img_size"], chans), np.float32)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
    jstate = jax.eval_shape(lambda v: jax_create_train_state(v, 1e-4)[0], variables)
    model = build_slot_model(ScouterConfig(**kw), fused_slot=True, device="meta")
    state = create_train_state(model, 1e-4)
    names = list(model.state_dict())
    torch_name = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[coll])[0]:
            one = {}
            node = one
            keys = _keys(path)
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.zeros([1] * len(leaf.shape), np.float32)
            carried = variables_to_state_dict({coll: one}, names)
            (name,) = [n for n in carried if not n.endswith("num_batches_tracked")]
            torch_name[(coll, tuple(keys))] = name
    return jstate, state, torch_name, names


def _carried(coll, keys, arr, names):
    """``arr`` (a leaf in JAX's layout) through the weight carrier."""
    tree = node = {}
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = arr
    out = variables_to_state_dict({coll: tree}, names)
    return next(v for n, v in out.items() if not n.endswith("num_batches_tracked"))


def _jax_leaves(jstate, shardings):
    """(collection, param keys, abstract leaf, sharding) of every parameter,
    BatchNorm statistic and AdamW first moment (``mu``; ``nu`` is checked
    to carry the same sharding)."""
    out = []
    for coll, tree, shtree in (("params", jstate.params, shardings.params),
                               ("batch_stats", jstate.batch_stats, shardings.batch_stats)):
        for (path, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                    jax.tree_util.tree_leaves(shtree)):
            out.append((coll, tuple(_keys(path)), leaf, sh))
    opt = jax.tree_util.tree_flatten_with_path(jstate.opt_state)[0]
    opt_sh = jax.tree_util.tree_leaves(shardings.opt_state)
    nu = {}
    for (path, leaf), sh in zip(opt, opt_sh):
        keys = _keys(path)
        for moment in ("mu", "nu"):
            if moment in keys:
                pkeys = tuple(keys[keys.index(moment) + 1:])
                if moment == "mu":
                    out.append(("mu", pkeys, leaf, sh))
                else:
                    nu[pkeys] = sh.spec
    assert nu and all(nu[k] == s.spec for c, k, _, s in out if c == "mu")
    return out


@pytest.mark.parametrize("zero1", [False, True], ids=["tp", "tp_zero1"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_partition_matches_jax_element_for_element(model_name, mesh_shape, zero1):
    jstate, state, torch_name, names = layouts(model_name)
    axes = ("data", "model")[:len(mesh_shape)]
    jmesh = jax_make_mesh(mesh_shape, axes)
    jsh = jax_train_state_shardings(jstate, jmesh, zero1=zero1)
    mesh = make_mesh(mesh_shape, axes, devices=list(range(8)))
    ours = train_state_shardings(state, mesh, zero1=zero1)
    trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
    seen = {"params": set(), "batch_stats": set(), "mu": set()}
    split = 0
    for coll, keys, leaf, sh in _jax_leaves(jstate, jsh):
        name = torch_name[("batch_stats" if coll == "batch_stats" else "params", keys)]
        seen[coll].add(name)
        spec = (ours.moments if coll == "mu" else
                ours.buffers if coll == "batch_stats" else ours.params)[name]
        shape = tuple(leaf.shape)
        ids = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        src = "batch_stats" if coll == "batch_stats" else "params"
        full = _carried(src, keys, ids, names)
        boxes = {}
        for d, dev in np.ndenumerate(jmesh.devices):
            box = sh.devices_indices_map(shape)[dev]
            coords = dict(zip(axes, d))
            mine = local_slices(full.shape, spec, mesh, coords)
            key = tuple((s.start, s.stop) for s in box)
            if key not in boxes:
                boxes[key] = _carried(src, keys, ids[box], names)
            assert torch.equal(full[mine], boxes[key]), (coll, name, d)
        split += len(boxes) > 1
    assert seen["params"] == {n for n, _ in state.model.named_parameters()}
    assert seen["batch_stats"] == {n for n in ours.buffers if n.endswith(("_mean", "_var"))}
    assert seen["mu"] == trainable
    assert all(s == () for n, s in ours.buffers.items() if n.endswith("num_batches_tracked"))
    assert split > 0 or (mesh_shape == (8,) and not zero1)  # (8,) alone shards nothing


def test_layout_rules_follow_the_carrier():
    """The cases where JAX's layout matters: an HWIO kernel splits torch's
    dim 0; the square ``to_k`` layers' ZeRO-1 tie goes to JAX's first axis;
    ``conv1x1.weight`` splits over model but its bias and the slot head's
    biases stay whole (``_in_backbone``); a Dense kernel splits torch's
    dim 1 where JAX's axis 0 wins."""
    assert torch_spec("backbone.layer1.0.conv1.weight", (64, 64, 3, 3), 2) == (
        "model", None, None, None)
    assert torch_spec("conv1x1.weight", (64, 512, 1, 1), 2) == ("model", None, None, None)
    assert torch_spec("conv1x1.bias", (64,), 2) == (None,)
    assert torch_spec("slot.gru.bias_ih_l0", (192,), 2) == (None,)
    assert torch_spec("backbone.bn1.running_mean", (64,), 2) == ("model",)
    assert torch_spec("slot.to_k.0.weight", (64, 64), 2, 2, zero1=True) == ("data", None)
    assert torch_spec("slot.initial_slots", (1, 30, 64), 2, 2, zero1=True) == (
        None, "model", "data")
    # a Dense kernel (in, out) = (64, 64) in JAX is torch's (out, in): the tie
    # goes to JAX's axis 0, torch's dim 1
    assert torch_spec("backbone.fc.weight", (64, 64), 1, 2, zero1=True) == (None, "data")
    assert torch_spec("backbone.fc.weight", (10, 64), 1, 2, zero1=True) == (None, "data")
    assert torch_spec("backbone.bn1.num_batches_tracked", (), 2, 2, zero1=True) == ()


@pytest.mark.parametrize("shape,axes", [((3,), ("data",)), ((2, 2, 2), ("data",)),
                                        ((4, 2), ("model",))],
                         ids=["size", "two_padded", "model_named"])
def test_make_mesh_raises_jax_errors(shape, axes):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(shape, axes)
    with pytest.raises(ValueError) as got:
        make_mesh(shape, axes, devices=list(range(8)))
    assert str(got.value) == str(want.value)


def test_make_mesh_lays_ranks_out_as_jax():
    mesh = make_mesh((4, 2), devices=list(range(8)))
    jmesh = jax_make_mesh((4, 2))
    assert mesh.axis_names == jmesh.axis_names == ("data", "model")
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.devices.tolist() == [[d.id for d in row] for row in jmesh.devices]
    one = make_mesh()  # a world of one process: no group, no collective
    assert one.shape == {"data": 1} and one.group("data") is None
    assert torch.equal(shard_batch(one, {"x": torch.arange(6)})["x"], torch.arange(6))


@pytest.mark.parametrize("n", [0, 1, 5, 11, 64, 1001])
def test_host_shard_bounds_match_jax(n):
    for pc in (1, 2, 3, 4, 8):
        for pi in range(pc):
            assert host_shard_bounds(n, process_index=pi, process_count=pc) == \
                jax_host_shard_bounds(n, process_index=pi, process_count=pc)


@pytest.mark.parametrize("ranks,batch", [(2, 2), (3, 2), (2, 5)])
def test_loader_batches_match_jax_multi_process(monkeypatch, ranks, batch):
    """11 items over ``ranks`` processes: each rank's train batches (one
    global permutation a epoch, this rank's slice, truncated to the smallest
    shard's full batches) and val batches (padded, fully masked where a
    shard runs out) equal JAX's multi-process Loader's, image for image."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (11, 8, 8, 1)).astype(np.uint8)
    labels = np.arange(11)
    for rank in range(ranks):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: ranks)
        monkeypatch.setattr(distributed, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(distributed, "get_world_size", lambda: ranks)
        for train in (True, False):
            jl = JaxLoader(JaxArrayDataset(images, labels, "MNIST"), batch, img_size=8,
                           train=train, seed=3)
            pl = Loader(ArrayDataset(images, labels, "MNIST"), batch, img_size=8,
                        train=train, seed=3, device="cpu")
            assert pl.steps_per_epoch() == jl.steps_per_epoch()
            for epoch in (0, 1):
                want = list(jl._host_batches(epoch))
                got = list(pl._host_batches(epoch))
                assert len(got) == len(want) == jl.steps_per_epoch()
                for g, w in zip(got, want):
                    for k in ("image", "label", "mask"):
                        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
                # the device batches carry the same rows and masks
                for g, w in zip(pl.epoch(epoch), want):
                    np.testing.assert_array_equal(g["label"].numpy(), w["label"])
                    np.testing.assert_array_equal(g["mask"].numpy(), w["mask"])


def _tiny(**kw):
    from scouter_tpu_torch.train import Trainer

    rng = np.random.RandomState(0)
    ds = ArrayDataset(rng.randint(0, 256, (8, 32, 32, 1)).astype(np.uint8),
                      rng.randint(0, 3, 8), "MNIST")
    cfg = ScouterConfig(**{**MODELS["resnet10"], "img_size": 32, "batch_size": 4,
                           "device": "cpu", **kw})
    return Trainer(cfg, datasets=(ds, ds))


def test_world_of_one_trains_as_without_a_mesh():
    """At world size 1 every collective is skipped: each mesh flag trains to
    the same numbers as no mesh at all, bit for bit."""
    runs = []
    for kw in ({}, dict(mesh_shape=(1,)), dict(mesh_shape=(1,), sync_bn=False),
               dict(mesh_shape=(1, 1), zero1=True)):
        trainer = _tiny(**kw)
        metrics = trainer.run_epoch(0, "train"), trainer.run_epoch(0, "val")
        runs.append((metrics, trainer.state.model.state_dict(),
                     trainer.state.optimizer.state_dict()["state"]))
    for metrics, model_sd, opt in runs[1:]:
        assert metrics == runs[0][0]
        assert all(torch.equal(v, runs[0][1][k]) for k, v in model_sd.items())
        assert all(torch.equal(e[k], runs[0][2][i][k]) for i, e in opt.items()
                   for k in ("exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_shape=(2,)), r"mesh shape \(2,\) != 1 devices"),
    (dict(zero1=True, sync_bn=False), "requires sync_bn=True"),
], ids=["mesh_not_the_world", "zero1_per_replica_bn"])
def test_trainer_raises_jax_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        _tiny(**kw)


def test_engine_splits_buckets_over_the_mesh():
    """``InferenceEngine(mesh=)`` over two CPU devices of this process serves
    each bucket in two halves and returns what the unmeshed engine returns;
    a bucket that does not divide the mesh raises JAX's error."""
    from scouter_tpu_torch.serve import InferenceEngine

    cfg = ScouterConfig(**MODELS["resnet10"], device="cpu")
    sd = build_slot_model(cfg, device="cpu").state_dict()
    images = np.random.RandomState(1).randint(0, 256, (6, 64, 64, 1)).astype(np.uint8)
    mesh = make_mesh((2,), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match=r"buckets \[1\] not divisible by the 2-device mesh"):
        InferenceEngine(cfg, sd, buckets=(1, 4), device="cpu", mesh=mesh)
    plain = InferenceEngine(cfg, sd, buckets=(2, 4), device="cpu")
    meshed = InferenceEngine(cfg, sd, buckets=(2, 4), device="cpu", mesh=mesh)
    try:
        want, got = plain.infer_batch(images), meshed.infer_batch(images)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        assert meshed.submit(images[0]).result(timeout=60)["logits"].shape == (3,)
    finally:
        plain.close()
        meshed.close()


def test_a_ranks_augmentation_draws_are_its_global_rows():
    """With ``--aug``, rank r of R preprocesses its rows with the draws that
    rows r*B..(r+1)*B of the global batch of R*B get."""
    from scouter_tpu_torch.data.transforms import preprocess_batch

    images = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (6, 16, 16, 1))
                              .astype(np.uint8))
    whole = preprocess_batch(images, dataset="MNIST", img_size=16, train=True, aug=True,
                             generator=torch.Generator().manual_seed(9))
    for r in range(3):
        mine = preprocess_batch(images[2 * r:2 * r + 2], dataset="MNIST", img_size=16,
                                train=True, aug=True, generator=torch.Generator().manual_seed(9),
                                rows=(2 * r, 6))
        assert torch.equal(mine, whole[2 * r:2 * r + 2])
