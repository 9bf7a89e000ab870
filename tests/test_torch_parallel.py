"""The port's multi-device runtime (``bio_image_unet_tpu_torch.parallel``,
``.testing``) held against the JAX package's on the CPU.

The multi-rank legs run in real gloo worlds of 2 ranks (a 1×2 mesh: H split
over ``spatial``) and 4 ranks (a 2×2 mesh: the batch over ``data`` too),
launched once for the file (``tests/torch_mesh.py``); JAX runs the same
inputs on its virtual CPU devices (``conftest.py``) in a mesh of the same
shape.  ``spatial_shard_apply`` of a 3-conv stack (float32 weights carried
across in HWIO) agrees to atol 1e-5 (``tests/test_parallel.py:63-78``,
``:135``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import testing as jtesting
from bio_image_unet_tpu.parallel import get_mesh as jget_mesh
from bio_image_unet_tpu.parallel import pad_to_multiple as jpad
from bio_image_unet_tpu.parallel import shard_batch as jshard_batch
from bio_image_unet_tpu.parallel import spatial_shard_apply as jspatial
from bio_image_unet_tpu_torch import parallel, testing
from bio_image_unet_tpu_torch.parallel.mesh import Mesh
from torch_mesh import leg, run_world

WORLDS = {
    # world: (n_data, n_spatial, halo, x, kernels)
    2: (1, 2, 3, "x2", ["k0", "k1", "k2"]),
    4: (2, 2, 2, "x4", ["k0", "k1"]),
}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    out = {"x2": rng.standard_normal((2, 4, 64, 32)).astype(np.float32),
           "x4": rng.standard_normal((4, 4, 32, 16)).astype(np.float32),
           "batch": rng.standard_normal((13, 4, 4, 1)).astype(np.float32)}
    for i in range(3):
        out[f"k{i}"] = (rng.standard_normal((3, 3, 4, 4)) * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Every rank's legs, per world size: one launch a world."""
    root = tmp_path_factory.mktemp("mesh")
    out = {}
    for world, (n_data, n_spatial, halo, x, kernels) in WORLDS.items():
        legs = [{"leg": "conv_stack", "name": "conv", "n_data": n_data, "n_spatial": n_spatial,
                 "halo": halo, "x": x, "kernels": kernels, "odd": n_data > 1},
                {"leg": "halo_edges", "name": "edges", "n_data": n_data,
                 "n_spatial": n_spatial, "halo": 2},
                {"leg": "divisible", "name": "divisible", "n_spatial": n_spatial},
                {"leg": "batch", "name": "batch", "n_data": world, "x": "batch"}]
        out[world] = run_world(world, legs, root / f"w{world}", inputs)
    return out


def _conv_stack(x, kernels):
    for k in kernels:
        x = jax.lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        x = jax.nn.leaky_relu(x, 0.1)
    return x


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_spatial_shard_apply_matches_jax(world, worlds, inputs):
    n_data, n_spatial, halo, x, kernels = WORLDS[world]
    mesh = jget_mesh(n_data=n_data, n_spatial=n_spatial, devices=jax.devices()[:world])
    ks = [jnp.asarray(inputs[k]) for k in kernels]
    xh = jnp.asarray(np.moveaxis(inputs[x], 1, -1))
    ref = np.moveaxis(np.asarray(jspatial(lambda t: _conv_stack(t, ks), xh, mesh, halo=halo)),
                      -1, 1)
    ranks = leg(worlds[world], "conv")
    for r in ranks:  # every rank returns the whole result
        np.testing.assert_allclose(r["out"], ref, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
    # the contract: fn on the halo-zero-padded image, cropped back; interior
    # rows equal fn(x)
    plain = np.moveaxis(np.asarray(_conv_stack(xh, ks)), -1, 1)
    np.testing.assert_allclose(ranks[0]["out"][:, :, halo:-halo], plain[:, :, halo:-halo],
                               rtol=0, atol=1e-5)
    if n_data > 1:  # an odd batch is replicated over data, H still split
        odd = np.moveaxis(np.asarray(jspatial(lambda t: _conv_stack(t, ks), xh[:3], mesh,
                                              halo=halo)), -1, 1)
        for r in ranks:
            np.testing.assert_allclose(r["odd"], odd, rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_halo_exchange_edges_are_zero(world, worlds):
    """Each block holds its rank + 1: a rank's top halo is its upper
    neighbour's bottom rows, the bottom halo its lower neighbour's top rows,
    and the first and last blocks of a data row get zeros; ranks sit at
    (r // n_spatial, r % n_spatial), as JAX's reshape puts its devices."""
    n_data, n_spatial, *_ = WORLDS[world]
    grid = np.asarray(jget_mesh(n_data=n_data, n_spatial=n_spatial,
                                devices=jax.devices()[:world]).devices)
    ids = np.vectorize(lambda d: d.id)(grid)
    for r, res in enumerate(leg(worlds[world], "edges")):
        d, s = res["coords"]
        assert (d, s) == (r // n_spatial, r % n_spatial) and ids[d, s] == r
        padded = res["padded"][0, 0]
        assert padded.shape == (8, 3)
        np.testing.assert_array_equal(padded[2:6], r + 1)
        np.testing.assert_array_equal(padded[:2], 0 if s == 0 else r)
        np.testing.assert_array_equal(padded[6:], 0 if s == n_spatial - 1 else r + 2)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_spatial_extent_must_divide(world, worlds):
    n_spatial = WORLDS[world][1]
    with pytest.raises(ValueError) as ref:
        jspatial(lambda t: t, jnp.zeros((1, 5, 4, 1)),
                 jget_mesh(n_data=1, n_spatial=n_spatial, devices=jax.devices()[:n_spatial]),
                 halo=1)
    for r in leg(worlds[world], "divisible"):
        assert str(r["error"]) == f"ValueError: {ref.value}"


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_shard_batch_pads_as_jax(world, worlds, inputs):
    """Padded by repeating the last row; each rank holds its contiguous
    slice of JAX's sharded array."""
    arr, n = jshard_batch(inputs["batch"], jget_mesh(n_data=world,
                                                     devices=jax.devices()[:world]))
    ref = np.asarray(arr)
    ranks = leg(worlds[world], "batch")
    assert n == 13 and ref.shape[0] == jpad(13, world)
    np.testing.assert_array_equal(np.concatenate([r["local"] for r in ranks]), ref)
    assert all(int(r["n"]) == n for r in ranks)


def test_mesh_of_one_and_its_errors(inputs):
    """No process group: the 1×1 mesh of this process, its collectives the
    identity; JAX's two errors (``mesh.py:49-57``) with JAX's words."""
    mesh = parallel.get_mesh()
    assert mesh.shape == {"data": 1, "spatial": 1} and not mesh.distributed
    assert mesh.coords == (0, 0) and mesh.devices.shape == (1, 1)
    t = torch.arange(6.0).view(2, 3)
    assert mesh.all_gather(t) is t and mesh.all_reduce(t) is t
    x = torch.from_numpy(inputs["x2"])
    k = torch.from_numpy(inputs["k0"].transpose(3, 2, 0, 1).copy())
    got = parallel.spatial_shard_apply(lambda v: torch.conv2d(v, k, padding=1), x, mesh, 3)
    want = torch.conv2d(torch.nn.functional.pad(x, (0, 0, 3, 3)), k, padding=1)[:, :, 3:-3]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    local, n = parallel.shard_batch(inputs["batch"], mesh, device="cpu")
    assert n == 13 and torch.equal(local, torch.from_numpy(inputs["batch"]))
    for kw in ({"n_data": 2}, {"n_spatial": 16}):
        with pytest.raises(ValueError) as ours:
            parallel.get_mesh(**kw)
        with pytest.raises(ValueError) as ref:
            jget_mesh(devices=jax.devices()[:1], **kw)
        assert str(ours.value) == str(ref.value)


def test_pad_to_multiple_and_placements_match_jax():
    for n in range(0, 20):
        for k in (1, 2, 3, 8):
            assert parallel.pad_to_multiple(n, k) == jpad(n, k)
    mesh = parallel.get_mesh()
    assert parallel.data_sharding(mesh, 3).spec == ("data", None, None)
    assert parallel.replicated(mesh).spec == ()
    t = torch.arange(12.0).view(4, 3)
    assert torch.equal(parallel.data_sharding(mesh, 2).local(t), t)


def test_mesh_refuses_a_device_its_backend_does_not_run():
    """A gloo mesh runs its collectives on CPU tensors and an NCCL mesh on
    the card's: a call on the other device raises, so no collective stages
    CUDA tensors through the host."""
    grid = np.zeros((1, 1), int)
    Mesh(grid, {}, (0, 0), "gloo").check_device(torch.device("cpu"))
    with pytest.raises(ValueError, match="gloo mesh runs its collectives on cpu"):
        Mesh(grid, {}, (0, 0), "gloo").check_device(torch.device("cuda"))
    with pytest.raises(ValueError, match="nccl mesh runs its collectives on cuda"):
        Mesh(grid, {}, (0, 0), "nccl").check_device(torch.device("cpu"))


def test_initialize_distributed_passes_its_keywords_and_defaults_to_nccl(monkeypatch):
    captured = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: captured.append(kw))
    parallel.initialize_distributed(backend="gloo", init_method="tcp://127.0.0.1:1",
                                    rank=1, world_size=2)
    assert captured == [{"backend": "gloo", "init_method": "tcp://127.0.0.1:1", "rank": 1,
                         "world_size": 2}]
    if not torch.cuda.is_available():  # NCCL is the default; gloo is never picked for you
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.initialize_distributed(init_method="tcp://127.0.0.1:1", rank=0,
                                            world_size=1)
        assert len(captured) == 1


PARITY_CASES = [
    ("equal", np.arange(5000, dtype=np.uint8) % 251, np.arange(5000, dtype=np.uint8) % 251),
    ("one level on 5 pixels", np.r_[np.ones(5, np.uint8), np.zeros(4995, np.uint8)],
     np.zeros(5000, np.uint8)),
    ("one level on 6 pixels", np.r_[np.ones(6, np.uint8), np.zeros(4994, np.uint8)],
     np.zeros(5000, np.uint8)),
    ("two levels", np.r_[np.full(1, 2, np.uint8), np.zeros(4999, np.uint8)],
     np.zeros(5000, np.uint8)),
    ("float within", np.r_[np.full(2, 1e-3, np.float32), np.zeros(4998, np.float32)],
     np.zeros(5000, np.float32)),
    ("float beyond", np.r_[np.full(1, 3e-3, np.float32), np.zeros(4999, np.float32)],
     np.zeros(5000, np.float32)),
    ("shape", np.zeros((2, 3), np.uint8), np.zeros((3, 2), np.uint8)),
    ("dtype", np.zeros(4, np.uint16), np.zeros(4, np.uint8)),
]


@pytest.mark.parametrize("case", PARITY_CASES, ids=[c[0] for c in PARITY_CASES])
def test_assert_mesh_parity_passes_and_fails_as_jax(case):
    _, a, b = case
    assert testing.__all__ == jtesting.__all__
    for name in ("MESH_PARITY_MAX_LEVELS", "MESH_PARITY_FLOAT_TOL", "MESH_PARITY_MAX_FRACTION"):
        assert getattr(testing, name) == getattr(jtesting, name)
    outcome = []
    for mod in (testing, jtesting):
        try:
            mod.assert_mesh_parity(a, b)
            outcome.append(None)
        except AssertionError as err:
            outcome.append(str(err))
    assert outcome[0] == outcome[1]
