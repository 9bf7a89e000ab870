"""The JAX package's own checkpoints in the port: ``BIUTPU01`` files written by
``bio_image_unet_tpu.checkpoint.save`` load in ``bio_image_unet_tpu_torch.
checkpoint.load`` bit-equal to ``state_dict_from_jax`` of the JAX package's
``load``, for each model class ``state_dict_from_jax`` covers; the port's
``save_native`` loads in the JAX package's ``load`` (its Trainer's
``opt_state_template`` included) with equal trees and header; the port's
``interop.torch_ckpt`` mirrors the JAX package's key rules and ``.pt``
export; ``Predict`` gives equal masks from a ``.ckpt`` and the equal ``.pt``.

The models are built and drawn in the port (seeded, random BatchNorm
statistics) and carried to JAX through the JAX package's own
``torch_state_dict_to_variables``: no JAX ``model.init``."""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.interop import torch_ckpt as jtorch_ckpt
from bio_image_unet_tpu.interop.pt_reader import read_pt
from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint as jexport
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.interop import (export_torch_checkpoint, load_torch_checkpoint,
                                              state_dict_from_jax, torch_key_to_flax,
                                              torch_state_dict_to_variables)
from bio_image_unet_tpu_torch.interop.opt_state import param_names
from bio_image_unet_tpu_torch.interop.torch_ckpt import flax_path
from bio_image_unet_tpu_torch.interop.weights import to_torch_layout
from bio_image_unet_tpu_torch.models import get_model
from bio_image_unet_tpu_torch.ops.blocks import init_weights_
from bio_image_unet_tpu_torch.predict import Predict, Predict3D, PredictMultiOutput
from torch_parity import assert_u8_contract  # noqa: F401  (sets one torch thread)

REPO = Path(__file__).resolve().parent.parent

# the ten classes state_dict_from_jax covers, with the hyperparams that
# rebuild each (Siam in its concat join: the one with conv_concat)
CLASSES = [
    ("Unet", {}),
    ("AttentionUnet", {}),
    ("Unet_v0", {}),
    ("BabyUnet", {}),
    ("Siam_UNet", {"mode": "concat"}),
    ("MultiOutputUnet", {}),
    ("MultiOutputNestedUNet", {}),
    ("MultiOutputNestedUNet_3Levels", {}),
    ("UNet3D", {"use_interpolation": False}),
    ("MultiOutputUnet3D", {"use_interpolation": True}),
]
IDS = [c[0] for c in CLASSES]


def _port_model(name, extra, seed=0):
    hyper = {"model_name": name, "n_filter": 4, "in_channels": 1, **extra}
    net = init_weights_(get_model(name, **hyper), torch.Generator().manual_seed(seed),
                        random_bn_stats=True)
    if getattr(net, "heads", None) is not None:
        hyper["output_heads"] = {k: dict(v) for k, v in net.heads.items()}
    return net, hyper


def _jax_variables(net):
    """The port model's weights as JAX variables, by the JAX package's rules."""
    return jtorch_ckpt.torch_state_dict_to_variables(
        {k: v.numpy() for k, v in net.state_dict().items()})


def _tx(grad_clip):
    """The JAX Trainer's optimizer (``trainer.py:275-280``)."""
    return optax.inject_hyperparams(lambda learning_rate: optax.chain(
        *([optax.clip_by_global_norm(grad_clip)] if grad_clip is not None else []),
        optax.adam(learning_rate)))(learning_rate=1e-3)


def _stepped_opt_state(tx, params, seed):
    """The optimizer state after two updates with seeded gradients."""
    rng = np.random.default_rng(seed)
    state = jax.jit(tx.init)(params)
    update = jax.jit(tx.update)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
        _, state = update(grads, state, params)
    state.hyperparams["learning_rate"] = np.asarray(3e-4, np.float32)
    return jax.device_get(state)


def _assert_state_dicts_equal(ours, ref):
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k


def _assert_trees_equal(ours, ref):
    assert isinstance(ours, dict) and sorted(ours) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_trees_equal(ours[k], v)
        else:
            a, b = np.asarray(ours[k]), np.asarray(v)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name,extra", CLASSES, ids=IDS)
def test_jax_written_ckpt_loads_bit_equal(tmp_path, name, extra):
    net, hyper = _port_model(name, extra)
    variables = _jax_variables(net)
    # every other class with the Adam state of a JAX Trainer, with and without a clip
    i = IDS.index(name)
    opt = (None if i % 2 else
           _stepped_opt_state(_tx(1.0 if i % 4 == 0 else None), variables["params"], i))
    path = str(tmp_path / "model.ckpt")
    hyper = {**hyper, "loss_params": (0.5, 0.5),
             "scheduler_state": {"best": 0.25, "num_bad": 1, "scale": 0.1}}
    jcheckpoint.save(path, variables, hyper, epoch=3, best_loss=0.25, opt_state=opt)

    ours, ref = checkpoint.load(path), jcheckpoint.load(path)
    _assert_state_dicts_equal(ours["state_dict"], state_dict_from_jax(ref["variables"]))
    assert ours["hyperparams"] == ref["hyperparams"]
    assert ours["hyperparams"]["scheduler_state"] == hyper["scheduler_state"]
    assert (ours["epoch"], ours["best_loss"]) == (3, 0.25)
    assert checkpoint.peek(path) == jcheckpoint.peek(path)
    net.load_state_dict(ours["state_dict"], strict=True)
    if opt is None:
        assert ours["optimizer_state_dict"] is None
        return
    adam = ours["optimizer_state_dict"]
    moments = opt.inner_state[-1][0]
    names = param_names(ours["state_dict"])
    assert sorted(names) == sorted(n for n, _ in net.named_parameters())
    assert adam["param_groups"][0]["lr"] == float(np.float32(3e-4))
    assert adam["param_groups"][0]["params"] == list(range(len(names)))
    for i, n in enumerate(names):
        path_ = flax_path(n)[1:]
        mu, nu = moments.mu, moments.nu
        for p in path_:
            mu, nu = mu[p], nu[p]
        assert adam["state"][i]["step"].item() == int(moments.count) == 2
        np.testing.assert_array_equal(adam["state"][i]["exp_avg"].numpy(), to_torch_layout(mu))
        np.testing.assert_array_equal(adam["state"][i]["exp_avg_sq"].numpy(),
                                      to_torch_layout(nu))
    # the state loads into the model's own Adam, renumbered by name
    by_name = dict(zip(names, (adam["state"][i] for i in range(len(names)))))
    own = [n for n, _ in net.named_parameters()]
    state = {"state": {j: by_name[n] for j, n in enumerate(own)},
             "param_groups": [{**adam["param_groups"][0], "params": list(range(len(own)))}]}
    optim = torch.optim.Adam(net.parameters())
    optim.load_state_dict(state)
    assert optim.param_groups[0]["lr"] == adam["param_groups"][0]["lr"]


@pytest.mark.parametrize("name,extra", CLASSES, ids=IDS)
def test_save_native_loads_in_jax(tmp_path, name, extra):
    net, hyper = _port_model(name, extra, seed=1)
    clip = IDS.index(name) % 2 == 0
    optim = torch.optim.Adam(net.parameters(), lr=2e-4)
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        for p in net.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        optim.step()
    for i, m in enumerate(m for m in net.modules() if hasattr(m, "num_batches_tracked")):
        m.num_batches_tracked.fill_(3 + i)
    path = str(tmp_path / "port.ckpt")
    hyper = {**hyper, "loss_params": (1, 1), "dilation": np.int64(1), "lr": np.float32(2e-4),
             "scheduler_state": {"best": 0.5, "num_bad": 0, "scale": 1.0}}
    checkpoint.save_native(path, net.state_dict(), hyper, epoch=2, best_loss=np.float32(0.5),
                           optimizer_state=optim.state_dict(), grad_clip=clip)

    # the port reads back every tensor, BatchNorm's batch counters included
    ours = checkpoint.load(path)["state_dict"]
    assert sorted(ours) == sorted(net.state_dict())
    for k, v in net.state_dict().items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k

    variables = _jax_variables(net)
    tx = _tx(1.0 if clip else None)
    ref = jcheckpoint.load(path, opt_state_template=jax.jit(tx.init)(variables["params"]))
    _assert_trees_equal(ref["variables"], variables)
    assert jcheckpoint.peek(path) == {"format": 1, "hyperparams": jcheckpoint._jsonable(hyper),
                                      "epoch": 2, "best_loss": 0.5, "has_opt_state": True}
    assert checkpoint.peek(path) == jcheckpoint.peek(path)
    opt = ref["opt_state"]
    assert int(opt.count) == 3 and float(opt.hyperparams["learning_rate"]) == np.float32(2e-4)
    moments = opt.inner_state[-1][0]
    assert int(moments.count) == 3
    mu, nu = {}, {}
    for i, (n, _) in enumerate(net.named_parameters()):
        for out, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            out[n] = optim.state[optim.param_groups[0]["params"][i]][key].numpy()
    for tree, ours in ((moments.mu, mu), (moments.nu, nu)):
        want = jtorch_ckpt.torch_state_dict_to_variables(ours)["params"]
        _assert_trees_equal(jax.device_get(tree), want)
    # the JAX Trainer's optimizer takes the restored state as its own
    grads = jax.tree_util.tree_map(np.ones_like, variables["params"])
    updates, _ = jax.jit(tx.update)(grads, opt, variables["params"])
    assert all(np.isfinite(u).all() for u in jax.tree_util.tree_leaves(updates))


@pytest.mark.parametrize("name,extra", CLASSES, ids=IDS)
def test_key_rules_match_jax_and_invert_state_dict_from_jax(tmp_path, name, extra):
    net, hyper = _port_model(name, extra, seed=3)
    sd = net.state_dict()
    ours = torch_state_dict_to_variables(sd)
    _assert_trees_equal(ours, _jax_variables(net))
    _assert_trees_equal(torch_state_dict_to_variables(state_dict_from_jax(ours)), ours)
    for k, v in sd.items():
        ref = jtorch_ckpt.torch_key_to_flax(k, v.numpy())
        got = torch_key_to_flax(k, v)
        assert (got is None) == (ref is None), k
        if ref is not None:
            assert got[0] == ref[0], k
            np.testing.assert_array_equal(got[1], ref[1])
    # the same .pt through both packages' readers
    pt = str(tmp_path / "model.pt")
    torch.save({"state_dict": sd, **hyper}, pt)
    _assert_trees_equal(load_torch_checkpoint(pt)["variables"],
                        jtorch_ckpt.load_torch_checkpoint(pt)["variables"])


@pytest.mark.parametrize("name,extra", CLASSES, ids=IDS)
def test_export_torch_checkpoint_matches_jax_export(tmp_path, name, extra):
    net, hyper = _port_model(name, extra, seed=4)
    variables = _jax_variables(net)
    ours, ref = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    export_torch_checkpoint(ours, variables, hyper, epoch=5, best_loss=0.125)
    jexport(ref, variables, hyper, epoch=5, best_loss=0.125,
            final_sequential=name != "UNet3D")
    a, b = read_pt(ours), read_pt(ref)
    assert sorted(a["state_dict"]) == sorted(b["state_dict"])
    for k, v in b["state_dict"].items():
        got = np.asarray(a["state_dict"][k])
        assert got.shape == np.shape(v), k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    assert {k: a[k] for k in hyper} == {k: b[k] for k in hyper}
    assert (a["epoch"], a["best_loss"]) == (5, 0.125)


def _both_files(tmp_path, name, extra):
    net, hyper = _port_model(name, extra, seed=5)
    variables = _jax_variables(net)
    ck, pt = str(tmp_path / "model.ckpt"), str(tmp_path / "model.pt")
    jcheckpoint.save(ck, variables, hyper, epoch=1)
    jexport(pt, variables, hyper, epoch=1, final_sequential=name != "UNet3D")
    return ck, pt


def test_predict_from_jax_ckpt_equals_pt(tmp_path):
    ck, pt = _both_files(tmp_path, "Unet", {})
    movie = np.random.default_rng(6).integers(0, 255, (3, 80, 72), dtype=np.uint8)
    kw = dict(resize_dim=(64, 64), show_progress=False, device="cpu")
    a, b = Predict(movie, None, ck, **kw).result, Predict(movie, None, pt, **kw).result
    assert a.shape == movie.shape and np.array_equal(a, b)


def test_predict_multi_output_and_3d_from_jax_ckpt_equal_pt(tmp_path):
    (tmp_path / "heads").mkdir()
    ck, pt = _both_files(tmp_path / "heads", "MultiOutputNestedUNet_3Levels", {})
    movie = np.random.default_rng(7).integers(0, 255, (2, 48, 40), dtype=np.uint8)
    kw = dict(max_patch_size=(32, 32), safe_margin=4, show_progress=False, device="cpu")
    a, b = PredictMultiOutput(movie, ck, **kw).result, PredictMultiOutput(movie, pt, **kw).result
    assert sorted(a) == sorted(b)
    for head in a:
        assert np.array_equal(a[head], b[head]), head
    (tmp_path / "3d").mkdir()
    ck, pt = _both_files(tmp_path / "3d", "UNet3D", {"use_interpolation": False})
    vol = np.random.default_rng(8).integers(0, 255, (12, 40, 36), dtype=np.uint8)
    kw = dict(resize_dim=(8, 32, 32), show_progress=False, device="cpu")
    a, b = Predict3D(vol, None, ck, **kw).result, Predict3D(vol, None, pt, **kw).result
    assert a.shape == vol.shape and np.array_equal(a, b)


def test_corrupt_native_files_raise_value_error_naming_the_path(tmp_path):
    ck, _ = _both_files(tmp_path, "Unet", {})
    data = Path(ck).read_bytes()
    (n,) = np.frombuffer(data[8:12], "<u4")
    cases = {"header-len": data[:10], "header": data[:12 + n // 2],
             "blob": data[:12 + n + (len(data) - 12 - n) // 2],
             "json": data[:12] + b"{" * n + data[12 + n:],
             "not-an-object": data[:8] + np.uint32(2).tobytes() + b"[]" + data[12 + n:],
             "no-variables": data[:12 + n] + serialization.msgpack_serialize({"x": 1})}
    rng = np.random.default_rng(9)
    for i in range(40):
        bad = bytearray(data)
        pos = int(rng.integers(12 + n, len(bad)))
        bad[pos] ^= 1 << int(rng.integers(8))
        cases[f"flip{i}"] = bytes(bad)
    for what, blob in cases.items():
        path = tmp_path / f"bad_{what}.ckpt"
        path.write_bytes(blob)
        try:
            checkpoint.load(str(path))
        except ValueError as err:
            assert str(path) in str(err), (what, err)
        else:
            assert what.startswith("flip"), what  # a flip inside a float stays a checkpoint
    for what in ("header-len", "header", "json", "not-an-object"):
        with pytest.raises(ValueError, match="bad_"):
            checkpoint.peek(str(tmp_path / f"bad_{what}.ckpt"))


BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "msgpack", "tensorboard",
           "bio_image_unet_tpu")


def test_port_and_chip_smoke_import_none_of_jax_msgpack_or_tensorboard():
    """No module of the port, and not ``chip_smoke.py``, imports JAX, flax,
    optax, ml_dtypes, msgpack, tensorboard or the JAX package (a name matched
    exactly or followed by '.': the port's own name starts with the JAX
    package's)."""
    files = sorted((REPO / "bio_image_unet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert any(f.name == "msgpack_codec.py" for f in files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if any(n == b or n.startswith(b + ".") for b in BLOCKED)]
            assert not bad, (str(path), bad)


def test_checkpoints_resume_and_profile_run_without_jax_msgpack_or_tensorboard(tmp_path):
    """With those modules unimportable: a ``BIUTPU01`` file written by the JAX
    package loads and predicts, ``save_native`` round-trips, and a Trainer
    saves ``model.ckpt``, resumes from it, recomputes (``remat``) and writes
    a profiler trace."""
    ck, _ = _both_files(tmp_path, "Unet", {})
    code = textwrap.dedent(f"""
        import glob, json, sys
        import numpy as np
        BLOCKED = {BLOCKED!r}
        for name in list(sys.modules):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                del sys.modules[name]
        for b in BLOCKED:
            sys.modules[b] = None
        sys.path.insert(0, {str(REPO)!r})
        import torch
        torch.set_num_threads(1)  # beside the other test workers
        from bio_image_unet_tpu_torch import checkpoint
        from bio_image_unet_tpu_torch.predict import Predict
        from bio_image_unet_tpu_torch.train import Trainer
        from bio_image_unet_tpu_torch.utils.synth import blob_sample
        tmp = {str(tmp_path)!r}
        state = checkpoint.load({ck!r})
        assert checkpoint.peek({ck!r})["format"] == 1
        movie = np.random.default_rng(0).integers(0, 255, (2, 40, 40), dtype=np.uint8)
        res = Predict(movie, None, {ck!r}, resize_dim=(32, 32), show_progress=False,
                      device="cpu").result
        assert res.shape == (2, 40, 40) and res.dtype == np.uint8
        checkpoint.save_native(tmp + "/again.ckpt", state["state_dict"], state["hyperparams"])
        again = checkpoint.load(tmp + "/again.ckpt")["state_dict"]
        assert all(torch.equal(v, again[k]) for k, v in state["state_dict"].items())
        rng = np.random.default_rng(1)
        items = []
        for _ in range(10):
            img, mask = blob_sample(rng, (64, 64))
            items.append({{"image": (img / 255.0).astype(np.float32)[None],
                           "mask": (mask / 255.0).astype(np.float32)[None]}})
        kw = dict(n_filter=4, batch_size=4, save_dir=tmp + "/run", seed=0, device="cpu",
                  save_name="model.ckpt", val_split=0.2)
        Trainer(items, 1, **kw).start()
        t = Trainer(items, 1, load_weights=tmp + "/run/model.ckpt", remat=True,
                    profile_dir=tmp + "/trace", **kw)
        assert t.epoch_start == 1
        t.start()
        with open(t.trace_paths[0]) as fh:
            assert json.load(fh)["traceEvents"]
        leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and
                        any(n == b or n.startswith(b + ".") for b in BLOCKED))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK"), out.stdout[-2000:]
