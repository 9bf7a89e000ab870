"""The port's Trainer resuming from the JAX Trainer's own ``model.ckpt``
(``BIUTPU01``, the optax state inside) and the JAX Trainer resuming from the
port's, on the CPU.

One JAX Trainer (``Unet``, n_filter 4, 64² blob tiles, batch 4, Adam with
``grad_clip``, its init jitted through ``torch_parity.jit_init``) trains one
epoch and writes ``model.ckpt``.  The port's Trainer resumes from it: its
weights, BatchNorm statistics, Adam moments, step, learning rate, plateau
scheduler, epoch and best loss are JAX's.  One Adam step from that state on
one batch then moves every parameter as optax does, within rtol 1e-5: both
optimizers take the same gradient (JAX's, of the JAX model's loss on the
batch), so the comparison holds the optimizer state, its mapping and the
step, not the two frameworks' float32 gradient sums (which Adam's normalized
step turns into up to ~lr on the conv biases in front of each BatchNorm,
whose gradient is rounding noise: ``tests/test_torch_train.py``).  Last,
the port trains an epoch and writes its own ``model.ckpt``, and a JAX
Trainer resumes from it: its restored optax state equals the port's Adam
state mapped back, and it trains on."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.parallel import get_mesh
from bio_image_unet_tpu.train import Trainer as JaxTrainer
from bio_image_unet_tpu_torch.interop import state_dict_from_jax, torch_state_dict_to_variables
from bio_image_unet_tpu_torch.interop.opt_state import adam_to_optax
from bio_image_unet_tpu_torch.interop.torch_ckpt import flax_path
from bio_image_unet_tpu_torch.interop.weights import to_torch_layout
from bio_image_unet_tpu_torch.train import Trainer
from bio_image_unet_tpu_torch.utils.synth import blob_sample
from torch_parity import jit_init

N_FILTER, SIZE, BATCH, LR, CLIP = 4, 64, 4, 1e-3, 1.0


class Tiles:
    """12 blob tiles in [0, 1]; ``layout`` 'hwc' (JAX) or 'chw' (port)."""

    def __init__(self, layout: str, n: int = 12, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            img, mask = blob_sample(rng, (SIZE, SIZE))
            img, mask = (img / 255.0).astype(np.float32), (mask / 255.0).astype(np.float32)
            if layout == "hwc":
                self.items.append({"image": img[..., None], "mask": mask[..., None]})
            else:
                self.items.append({"image": img[None], "mask": mask[None]})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _jax_trainer(save_dir, epochs=1, **kw):
    with jit_init():
        return JaxTrainer(Tiles("hwc"), epochs, network="Unet", batch_size=BATCH, lr=LR,
                          n_filter=N_FILTER, save_dir=str(save_dir), seed=0,
                          mesh=get_mesh(n_data=1), grad_clip=CLIP, **kw)


def _port_trainer(save_dir, epochs=1, **kw):
    return Trainer(Tiles("chw"), epochs, network="Unet", batch_size=BATCH, lr=LR,
                   n_filter=N_FILTER, save_dir=str(save_dir), seed=0, device="cpu",
                   grad_clip=CLIP, **kw)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer after one epoch and its ``model.ckpt``; the scheduler
    is put in a decayed state first so that the file carries one."""
    root = tmp_path_factory.mktemp("jax_resume")
    t = _jax_trainer(root)
    t.scheduler.best, t.scheduler.num_bad, t.scheduler.scale = 10.0, 2, 0.5
    t.start()
    ckpt = str(root / "model.ckpt")
    assert os.path.exists(ckpt) and jcheckpoint.peek(ckpt)["has_opt_state"]
    return t, ckpt


def _moments(opt_state):
    """optax's (count, mu, nu) of Adam inside the Trainer's chain."""
    adam = opt_state.inner_state[-1][0]
    return int(adam.count), adam.mu, adam.nu


def _at(tree, name):
    for p in flax_path(name)[1:]:
        tree = tree[p]
    return np.asarray(tree)


def test_port_resumes_the_jax_trainers_ckpt(jax_run, tmp_path):
    jt, ckpt = jax_run
    t = _port_trainer(tmp_path, load_weights=ckpt)
    state = jcheckpoint.load(ckpt, opt_state_template=jt.opt_state)
    # weights and BatchNorm statistics
    ref = state_dict_from_jax(jax.device_get({"params": jt.params,
                                              "batch_stats": jt.batch_stats}))
    for k, v in t.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    # Adam: moments, step and learning rate, by name
    count, mu, nu = _moments(jt.opt_state)
    assert count == int(jt.opt_state.count) > 0
    lr = float(np.asarray(jt.opt_state.hyperparams["learning_rate"]))
    assert t.optimizer.param_groups[0]["lr"] == lr
    for name, p in t.model.named_parameters():
        s = t.optimizer.state[p]
        assert s["step"].item() == count
        np.testing.assert_array_equal(s["exp_avg"].numpy(), to_torch_layout(_at(mu, name)))
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), to_torch_layout(_at(nu, name)))
    # the plateau scheduler, epoch and best loss, as the JAX Trainer resumes them
    sched = state["hyperparams"]["scheduler_state"]
    assert t.scheduler.state() == {"best": sched["best"], "num_bad": sched["num_bad"],
                                   "scale": sched["scale"]}
    assert (jt.scheduler.best, jt.scheduler.num_bad, jt.scheduler.scale) == (
        sched["best"], sched["num_bad"], sched["scale"])
    assert t.epoch_start == state["epoch"] == 0
    assert t.best_loss == state["best_loss"] == jt.best_loss


def test_one_adam_step_after_the_resume_matches_optax(jax_run, tmp_path):
    jt, ckpt = jax_run
    t = _port_trainer(tmp_path, load_weights=ckpt)
    params, stats = jax.device_get(jt.params), jax.device_get(jt.batch_stats)
    batch = {k: jnp.asarray(np.stack([Tiles("hwc")[i][k] for i in range(BATCH)]))
             for k in ("image", "mask")}

    def loss_fn(p):
        outputs, _ = jt.model.apply({"params": p, "batch_stats": stats}, batch["image"],
                                    train=True, mutable=["batch_stats"])
        return jt._compute_loss(outputs, batch, train=True)

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(params))
    updates, _ = jax.jit(jt.tx.update)(grads, jt.opt_state, params)
    want = jax.device_get(optax.apply_updates(params, updates))

    t.optimizer.zero_grad(set_to_none=True)
    for name, p in t.model.named_parameters():
        p.grad = torch.from_numpy(np.ascontiguousarray(to_torch_layout(_at(grads, name))))
    torch.nn.utils.clip_grad_norm_(t.model.parameters(), CLIP)
    t.optimizer.step()
    for name, p in t.model.named_parameters():
        ref = to_torch_layout(_at(want, name))
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-5, atol=1e-7, err_msg=name)
        moved = np.abs(ref - to_torch_layout(_at(params, name))).max()
        assert moved > 0, name


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv")) as fh:
        return [r for r in csv.reader(fh)][1:]


def test_jax_trainer_resumes_the_ports_ckpt(jax_run, tmp_path):
    _, ckpt = jax_run
    port = _port_trainer(tmp_path / "port", load_weights=ckpt, save_name="model.ckpt")
    port.start()
    ours = str(tmp_path / "port" / "model.ckpt")
    assert os.path.exists(ours) and jcheckpoint.peek(ours)["epoch"] == 1
    jt = _jax_trainer(tmp_path / "jax", load_weights=ours)
    assert jt.epoch_start == 1 and jt.best_loss == port.best_loss
    assert (jt.scheduler.best, jt.scheduler.num_bad, jt.scheduler.scale) == tuple(
        port.scheduler.state().values())
    variables = torch_state_dict_to_variables(port.model.state_dict())
    for tree, ref in ((jt.params, variables["params"]),
                      (jt.batch_stats, variables["batch_stats"])):
        got, want = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0], ref
        assert len(got) == len(jax.tree_util.tree_leaves(want))
        for path, leaf in got:
            node = want
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(np.asarray(leaf), node)
    # the restored optax state is the port's Adam state mapped back
    sd = port.model.state_dict()
    names = [n for n, _ in port.model.named_parameters()]
    mapped = adam_to_optax(port.optimizer.state_dict(), names,
                           {n: tuple(sd[n].shape) for n in names}, grad_clip=True)
    from flax import serialization

    restored = serialization.to_state_dict(jax.device_get(jt.opt_state))
    leaves = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(mapped))
    for path, leaf in leaves:
        node = mapped
        for key in path:
            node = node[key.key]
        assert np.asarray(leaf).dtype == np.asarray(node).dtype
        np.testing.assert_array_equal(np.asarray(leaf), node)
    # and it trains on from there
    jt.start()
    rows = _rows(tmp_path / "jax")
    assert [r[0] for r in rows] == ["1"] and np.isfinite(float(rows[0][1]))
