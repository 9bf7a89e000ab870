"""The port's model, weights, checkpoint, BN fold, TIFF and device rules,
held against the JAX package on the same weights and inputs."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.predict.fastpath import build_fast_apply
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.models import Unet, get_model
from bio_image_unet_tpu_torch.ops.blocks import init_weights_
from bio_image_unet_tpu_torch.predict.fastpath import FoldedUnet2D, fold_unet2d
from bio_image_unet_tpu_torch.progress import ProgressNotifier
from bio_image_unet_tpu_torch.utils import resolve_device, save_as_tif
from torch_parity import N_FILTER, write_unet_checkpoint

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def unet_ckpt(tmp_path_factory):
    return write_unet_checkpoint(tmp_path_factory.mktemp("ckpt") / "unet.pt")


@pytest.fixture(scope="module")
def port_unet(unet_ckpt):
    path, _, _ = unet_ckpt
    net = get_model("Unet", **checkpoint.load(path)["hyperparams"])
    net.load_state_dict(checkpoint.load(path)["state_dict"], strict=True)
    return net.eval()


def _input(rng, n=2, size=32):
    return rng.random((n, size, size, 1)).astype(np.float32)


def test_unet_eval_forward_matches_jax(unet_ckpt, port_unet, rng):
    _, model, variables = unet_ckpt
    x = _input(rng)
    apply = jax.jit(lambda v, a: model.apply(v, a, train=False))
    ref_p, ref_z = (np.asarray(v) for v in apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        p, z = port_unet(torch.from_numpy(np.moveaxis(x, -1, 1)))
    assert z.dtype == torch.float32
    np.testing.assert_allclose(np.moveaxis(z.numpy(), 1, -1), ref_z, atol=2e-4)
    np.testing.assert_allclose(np.moveaxis(p.numpy(), 1, -1), ref_p, atol=2e-4)


def test_folded_forward_matches_jax_fold_and_apply(unet_ckpt, port_unet, rng):
    _, model, variables = unet_ckpt
    x = _input(rng, n=3)
    apply = jax.jit(lambda v, a: model.apply(v, a, train=False))
    ref_z = np.asarray(apply(variables, jnp.asarray(x))[1])
    apply_fn, packed = build_fast_apply(model, variables, None)
    ref_fast = np.asarray(apply_fn(packed, jnp.asarray(x))[1])
    folded = FoldedUnet2D(port_unet, torch.float32, "cpu")
    with torch.no_grad():
        p, z = folded(torch.from_numpy(np.moveaxis(x, -1, 1)))
    z = np.moveaxis(z.numpy(), 1, -1)
    np.testing.assert_allclose(z, ref_z, atol=2e-4)
    np.testing.assert_allclose(z, ref_fast, atol=2e-4)
    np.testing.assert_allclose(p.numpy(), torch.sigmoid(torch.from_numpy(
        np.moveaxis(z, -1, 1))).numpy(), atol=1e-6)


def test_fold_matches_jax_fold(unet_ckpt, port_unet):
    """The folded kernels and biases equal the JAX fold's (f32, same formula)."""
    from bio_image_unet_tpu.predict.fastpath import fold_unet2d as jfold

    _, _, variables = unet_ckpt
    ours = fold_unet2d(port_unet.state_dict())
    ref = jfold(variables)
    assert set(ours) == set(ref)
    for name in ("encode1", "middle_conv2", "decode8"):
        k = np.transpose(np.asarray(ref[name]["kernel"]), (3, 2, 0, 1))
        np.testing.assert_allclose(ours[name]["weight"].numpy(), k, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ours[name]["bias"].numpy(), np.asarray(ref[name]["bias"]),
                                   rtol=1e-6, atol=1e-6)


def test_bf16_folded_forward_is_channels_last_and_close(port_unet, rng):
    x = torch.from_numpy(np.moveaxis(_input(rng), -1, 1))
    f32 = FoldedUnet2D(port_unet, torch.float32, "cpu")
    bf16 = FoldedUnet2D(port_unet, torch.bfloat16, "cpu")
    assert bf16.params["encode2"]["weight"].is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        z32 = f32.logits(x)
        z16 = bf16.logits(x.to(torch.bfloat16))
    assert z16.dtype == torch.bfloat16
    err = (z16.float() - z32).abs().max().item()
    assert err < 0.1 * max(1.0, z32.abs().max().item()), err


def test_state_dict_from_jax_equals_exported_pt(unet_ckpt):
    path, _, variables = unet_ckpt
    ours = state_dict_from_jax(variables)
    loaded = checkpoint.load(path)["state_dict"]
    assert set(ours) == set(loaded)
    for k, v in loaded.items():
        assert ours[k].dtype == v.dtype, k
        assert torch.equal(ours[k], v), k
    net = Unet(n_filter=N_FILTER)
    missing, unexpected = net.load_state_dict(ours, strict=True)
    assert not missing and not unexpected


def test_state_dict_from_jax_rejects_unknown_blocks():
    with pytest.raises(ValueError, match="unmapped"):
        state_dict_from_jax({"params": {"attention1": {"W_x_conv": {}}}})


def test_checkpoint_load_and_peek(unet_ckpt):
    path = unet_ckpt[0]
    state = checkpoint.load(path)
    assert state["hyperparams"]["n_filter"] == N_FILTER
    assert state["hyperparams"]["model_name"] == "Unet"
    assert state["epoch"] == 1 and state["best_loss"] == 0.5
    meta = checkpoint.peek(path)
    assert meta["hyperparams"] == state["hyperparams"] and "state_dict" not in meta


def test_checkpoint_refuses_biutpu01_and_garbage(unet_ckpt, tmp_path):
    _, _, variables = unet_ckpt
    native = tmp_path / "model.ckpt"
    jcheckpoint.save(str(native), variables, {"model_name": "Unet", "n_filter": N_FILTER})
    with pytest.raises(NotImplementedError, match="not yet supported by the port"):
        checkpoint.load(native)
    junk = tmp_path / "junk.pt"
    junk.write_bytes(b"not a checkpoint at all")
    with pytest.raises(ValueError):
        checkpoint.load(junk)


def test_get_model_rules():
    net = get_model("Unet", n_filter=4, epoch=3, model_name="Unet", lr=0.1)
    assert isinstance(net, Unet) and net.n_filter == 4
    # every registry name of the JAX package is ported, the legacy ones too
    assert get_model("Unet_v0", n_filter=4, model_name="Unet_v0").levels == 4
    assert get_model("BabyUnet", model_name="BabyUnet").n_filter == 4
    assert get_model("AttentionUnet", n_filter=4, model_name="AttentionUnet").attention
    with pytest.raises(ValueError, match="unknown model"):
        get_model("NoSuchNet")
    with pytest.raises(ValueError, match="NCHW"):
        net(torch.zeros((1, 2, 32, 32)))


def test_init_weights_is_seeded():
    a = init_weights_(Unet(n_filter=4), torch.Generator().manual_seed(3), random_bn_stats=True)
    b = init_weights_(Unet(n_filter=4), torch.Generator().manual_seed(3), random_bn_stats=True)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.allclose(a.encode1[1].running_var, torch.ones(4))


@pytest.mark.parametrize("normalize", [False, True])
def test_save_as_tif_reads_back_in_jax(tmp_path, rng, normalize):
    data = rng.integers(0, 256, (3, 20, 24)).astype(np.uint8)
    path = str(tmp_path / "mask.tif")
    save_as_tif(data, path, normalize=normalize)
    back = jtiff.imread(path)
    want = data.astype(np.float16)
    if normalize:
        lo, hi = float(data.min()), float(data.max())
        want = ((data - lo) * (255.0 / (hi - lo))).astype(np.float16)
    assert back.dtype == np.float16
    np.testing.assert_array_equal(back, want)


def test_port_tiff_reads_jax_tiff(tmp_path, rng):
    from bio_image_unet_tpu_torch.data import tiff

    data = rng.integers(0, 65535, (4, 17, 31)).astype(np.uint16)
    path = str(tmp_path / "movie.tif")
    jtiff.imwrite(path, data, compress=True)
    np.testing.assert_array_equal(tiff.imread(path), data)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_progress_without_tqdm(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tqdm", None)
    it = ProgressNotifier.progress_notifier_tqdm().iterator([1, 2])
    assert list(it) == [1, 2]
    assert "100.0%" in capsys.readouterr().err


def test_port_imports_no_jax(tmp_path):
    """Every port module imports, and a CPU Predict runs, with JAX, flax,
    ml_dtypes and the JAX package made unimportable.  The names are matched
    exactly or with a '.' after them: 'bio_image_unet_tpu_torch' starts with
    'bio_image_unet_tpu' but is not part of it."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import numpy as np
        BLOCKED = ("jax", "jaxlib", "flax", "ml_dtypes", "bio_image_unet_tpu")
        for name in list(sys.modules):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                del sys.modules[name]
        for b in BLOCKED:
            sys.modules[b] = None
        sys.path.insert(0, {str(REPO)!r})
        import torch
        import bio_image_unet_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        from bio_image_unet_tpu_torch.models import Unet
        from bio_image_unet_tpu_torch.ops.blocks import init_weights_
        from bio_image_unet_tpu_torch.predict import Predict
        net = init_weights_(Unet(n_filter=4), torch.Generator().manual_seed(0), True)
        path = {str(tmp_path / "u.pt")!r}
        torch.save({{"state_dict": net.state_dict(), "model_name": "Unet",
                    "n_filter": 4}}, path)
        movie = np.random.default_rng(0).integers(0, 255, (2, 40, 40), dtype=np.uint8)
        res = Predict(movie, None, path, resize_dim=(32, 32), show_progress=False,
                      device="cpu").result
        assert res.shape == (2, 40, 40) and res.dtype == np.uint8
        res = Predict(movie, None, path, resize_dim=(32, 32), show_progress=False,
                      device="cpu", quantized=True).result
        assert res.shape == (2, 40, 40) and res.dtype == np.uint8
        leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and
                        any(n == b or n.startswith(b + ".") for b in BLOCKED))
        assert not leaked, leaked
        print("OK", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK"), out.stdout
