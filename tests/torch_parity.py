"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

The port is held against the JAX package on the same weights and inputs:
one JAX ``Unet`` with warmed BatchNorm statistics is written to a reference
``.pt`` by ``bio_image_unet_tpu.interop.torch_export``, and both packages load
that same file.  Inputs are drawn with numpy from a seed and handed to both.
"""

from __future__ import annotations

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.models import Unet

# One intra-op thread a process: the Tier-1 command runs six pytest workers
# on eight cores, and with torch's default of a thread per core their CPU
# ops oversubscribe the machine; small ops (a BatchNorm warm-up, a fold)
# then slow down by two orders of magnitude.  ``DEFAULT_THREADS`` is the
# count torch started with (``default_threads`` restores it).
DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)


@contextmanager
def default_threads():
    """torch's default intra-op thread count, for a test whose float32 sums
    were measured with it."""
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(1)


N_FILTER = 8


def warm_unet_variables(n_filter: int = N_FILTER, size: int = 32, steps: int = 3,
                        seed: int = 0, cls=Unet):
    """A JAX ``Unet`` (or another 2D trunk ``cls``) and its variables after a
    few train-mode applies, so the BatchNorm running statistics are not the
    trivial mean 0 / var 1 and a BN fold has something to fold (the pattern
    of ``tests/test_fastpath.py``)."""
    model = cls(n_filter=n_filter)
    # one jitted init: a few seconds of compile, not ~30 s of op-by-op dispatch
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 1)))

    @jax.jit
    def step(variables, x, key):
        _, mutated = model.apply(variables, x, train=True, mutable=["batch_stats"],
                                 rngs={"dropout": key})
        return {"params": variables["params"], "batch_stats": mutated["batch_stats"]}

    key = jax.random.PRNGKey(seed + 7)
    for i in range(steps):
        x = jax.random.uniform(jax.random.fold_in(key, i), (2, size, size, 1))
        variables = step(variables, x, jax.random.fold_in(key, 100 + i))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def write_unet_checkpoint(path, n_filter: int = N_FILTER):
    """Write a reference-schema ``.pt`` of a warmed JAX ``Unet``; returns
    ``(path, model, variables)``."""
    model, variables = warm_unet_variables(n_filter)
    export_torch_checkpoint(str(path), variables,
                            {"model_name": "Unet", "n_filter": n_filter,
                             "in_channels": 1, "out_channels": 1},
                            epoch=1, best_loss=0.5)
    return str(path), model, variables


def assert_u8_contract(ours, ref, max_levels: int = 1, max_fraction: float = 1e-3):
    """uint8 masks agree within ``max_levels`` on at most ``max_fraction`` of
    pixels (the cross-layout contract of ``bio_image_unet_tpu.testing``)."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert ours.dtype == ref.dtype, (ours.dtype, ref.dtype)
    diff = np.abs(ours.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= max_levels, f"max divergence {diff.max()} > {max_levels}"
    frac = float(np.mean(diff > 0))
    assert frac <= max_fraction, f"{frac:.3%} of pixels diverge (allowed {max_fraction:.1%})"


def write_seeded_checkpoint(root, name: str, registry: str, seed: int, n_filter: int = 4,
                            warm: bool = False, **extra):
    """A reference-schema ``.pt`` of a seeded model both packages load (a
    3D net, or ``Siam_UNet`` with its ``mode`` in ``extra``): random weights
    and BatchNorm statistics (so the BN fold has something to fold) drawn in
    the port's model, read by the JAX package's ``.pt`` reader and written
    back by its ``export_torch_checkpoint`` (``final_sequential=False`` for
    ``UNet3D``, whose ``final`` is a bare ``Conv3d``).  With ``warm`` the
    weights are instead torch's default initialization and the BatchNorm
    statistics come from five train-mode forwards on seeded 64² inputs
    ((16, 32, 32) volumes for the 3D nets), the BN-warmed models of the JAX
    package's int8 tests (``tests/test_quant.py``,
    ``tests/test_quant_families.py``).  Returns ``(path, JAX variables)``."""
    from bio_image_unet_tpu import checkpoint as jcheckpoint
    from bio_image_unet_tpu_torch.models import get_model
    from bio_image_unet_tpu_torch.ops.blocks import init_weights_

    hyper = {"model_name": registry, "n_filter": n_filter, "in_channels": 1, **extra}
    gen = torch.Generator().manual_seed(seed)
    if warm:
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            net = get_model(registry, **hyper).train()
        shape = (2, 1, 16, 32, 32) if "3D" in registry else (2, 1, 64, 64)
        with torch.no_grad():
            for _ in range(5):
                x = torch.rand(shape, generator=gen)
                net(x, torch.rand(shape, generator=gen)) if extra.get("mode") else net(x)
        net.eval()
    else:
        net = init_weights_(get_model(registry, **hyper), gen, random_bn_stats=True)
    drawn = str(root / f"{name}_drawn.pt")
    torch.save({"state_dict": net.state_dict(), **hyper}, drawn)
    variables = jcheckpoint.load(drawn)["variables"]
    path = str(root / f"{name}.pt")
    export_torch_checkpoint(path, variables, hyper, final_sequential=registry != "UNet3D")
    return path, variables


def jit_init():
    """A context in which the JAX Trainer initializes its model with one
    jitted ``model.init`` in place of an eager one (``trainer.py:52
    _init_on_cpu``): the same initializers and keys, a few seconds of compile
    in place of some 30 s of op-by-op dispatch on the CPU.  The parity tests
    export those initial weights and start the port from them, so the values
    need not match an eager init."""
    from unittest import mock

    from bio_image_unet_tpu.train import trainer

    return mock.patch.object(trainer, "_init_on_cpu",
                             lambda model, rng, *args: jax.jit(model.init)(rng, *args))


def port_folded(variables):
    """JAX's folded float32 arrays (``bio_image_unet_tpu.predict.fastpath.
    fold_unet2d``) in the port's layout (``(*k, A, B)`` → ``(B, A, *k)``,
    block names as the port's state dict has them): the two folds round
    differently in the last bit (XLA's rsqrt), which the int8 requant can
    turn into a code, so the int8 forward parity runs on the same folded
    weights.  Nested blocks keep their nesting: a UNet++ cell ``grid_conv<i>_<j>``
    becomes ``conv<i>_<j>: {'stage1', 'stage2'}``, an attention gate
    ``attention<k>: {'W_gate', 'W_x', 'psi'}``."""
    from bio_image_unet_tpu.predict.fastpath import fold_unet2d

    def layer(p):
        if "kernel" not in p:
            return {k: layer(v) for k, v in p.items()}
        kern = np.asarray(p["kernel"], np.float32)
        nsp = kern.ndim - 2
        kern = np.transpose(kern, (nsp + 1, nsp) + tuple(range(nsp)))
        return {"weight": torch.from_numpy(np.ascontiguousarray(kern)),
                "bias": torch.from_numpy(np.asarray(p["bias"], np.float32).copy())}

    return {name.replace("output_layers_", "output_layers.").replace("grid_conv", "conv"):
            layer(p) for name, p in fold_unet2d(variables).items()}
