"""The port's msgpack codec (``bio_image_unet_tpu_torch/interop/msgpack_codec.py``)
held against msgpack-python and flax's ``msgpack_serialize`` /
``msgpack_restore``, the encoding of the JAX package's ``BIUTPU01``
checkpoints.  The test imports ``msgpack`` and flax; the port imports
neither."""

import random

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from bio_image_unet_tpu_torch.interop import msgpack_codec as codec

scalars = (st.none() | st.booleans()
           | st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
trees = st.recursive(scalars, lambda kids: st.lists(kids, max_size=6)
                     | st.dictionaries(st.text(max_size=8), kids, max_size=6), max_leaves=30)


@settings(max_examples=150, deadline=None)
@given(trees)
def test_round_trip_and_bytes_equal_msgpack_python(tree):
    ours = codec.packb(tree)
    assert ours == msgpack.packb(tree)
    assert codec.unpackb(ours) == tree == msgpack.unpackb(ours)


@settings(max_examples=60, deadline=None)
@given(trees)
def test_decodes_single_floats_as_msgpack_does(tree):
    data = msgpack.packb(tree, use_single_float=True)
    assert codec.unpackb(data) == msgpack.unpackb(data)


@pytest.mark.parametrize("value", [
    "x" * 31, "x" * 32, "é" * 200, "y" * 70_000, b"z" * 255, b"z" * 256, b"w" * 70_000,
    list(range(15)), list(range(16)), list(range(70_000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): None for i in range(70_000)},
    [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
     -1, -32, -33, -128, -129, -32768, -32769, -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)],
], ids=["fixstr", "str8", "str8-utf8", "str32", "bin8", "bin16", "bin32", "fixarray",
        "array16", "array32", "fixmap", "map16", "map32", "ints"])
def test_every_length_class_and_int_width(value):
    data = codec.packb(value)
    assert data == msgpack.packb(value)
    assert codec.unpackb(data) == value


def _flax_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                            "bias": np.zeros(4, np.float32)}},
        "count": np.asarray(7, np.int32),
        "ints": rng.integers(-5, 5, (2, 3)).astype(np.int32),
        "scalar_f": np.float32(2.5),
        "scalar_i": np.int64(-3),
        "complex": 1.5 - 2.0j,
        "half": np.asarray(jnp.asarray(rng.standard_normal((2, 5)), jnp.bfloat16)),
        "half_0d": np.asarray(jnp.asarray(0.75, jnp.bfloat16)),
        "empty": np.zeros((0, 3), np.float32),
        "nested": {"list": [1, "two", None], "opt": {}},
    }


def _as_port(tree):
    """The tree as the port writes it: bfloat16 arrays as torch tensors."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return tree


def _assert_tree_equal(ours, ref):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref)
        for k in ref:
            _assert_tree_equal(ours[k], ref[k])
    elif isinstance(ref, np.ndarray) and ref.dtype.name == "bfloat16":
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16
        assert tuple(ours.shape) == ref.shape
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(), ref.view(np.int16))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(ours) is type(ref) and ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    else:
        assert type(ours) is type(ref) and ours == ref


def test_flax_trees_decode_equal_and_encode_to_flax_bytes():
    tree = _flax_tree()
    data = serialization.msgpack_serialize(tree)
    _assert_tree_equal(codec.restore(data), serialization.msgpack_restore(data))
    assert codec.serialize(_as_port(tree)) == data
    # the decoded arrays are writable and share one copy of the input
    arr = codec.restore(data)["params"]["conv"]["kernel"]
    assert arr.flags.writeable


def test_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((5, 7, 3)).astype(np.float32),
            "inner": {"big16": np.asarray(jnp.asarray(rng.standard_normal(50), jnp.bfloat16)),
                      "small": np.arange(3, dtype=np.int32)}}
    data = serialization.msgpack_serialize(tree)
    raw = msgpack.unpackb(data)
    assert raw["big"]["__msgpack_chunked_array__"] and len(raw["big"]["chunks"]) == 7
    _assert_tree_equal(codec.restore(data), serialization.msgpack_restore(data))
    assert codec.serialize(_as_port(tree)) == data


def _only_value_error(data):
    try:
        codec.restore(data)
    except ValueError:
        return False
    return True


def test_truncated_input_raises_value_error_only():
    data = serialization.msgpack_serialize(_flax_tree())
    for n in range(len(data)):
        with pytest.raises(ValueError):
            codec.restore(data[:n])
    with pytest.raises(ValueError):
        codec.restore(data + b"\x00")


def test_bit_flips_raise_value_error_only():
    data = bytearray(serialization.msgpack_serialize(_flax_tree()))
    rng = random.Random(0)
    for _ in range(3000):
        bad = bytearray(data)
        for _ in range(rng.randint(1, 3)):
            bad[rng.randrange(len(bad))] ^= 1 << rng.randrange(8)
        _only_value_error(bytes(bad))


@settings(max_examples=300, deadline=None)
@given(st.binary(max_size=200))
def test_random_bytes_raise_value_error_only(data):
    _only_value_error(data)


@pytest.mark.parametrize("data", [
    b"\x91" * 100_000 + b"\xc0",                  # nesting deeper than the stack
    b"\xdd\xff\xff\xff\xff",                       # an array32 that claims 4 G items
    b"\xdb\xff\xff\xff\xff",                       # a str32 past the end
    b"\xa2\xff\xfe",                               # not UTF-8
    b"\x81\x90\xc0",                               # a list as a map key
    b"\xc1",                                       # the never-used type byte
    msgpack.packb(msgpack.ExtType(1, codec.packb([[2, 2], "float32", b"\x00" * 15]))),
    msgpack.packb(msgpack.ExtType(1, codec.packb([[2], "no such dtype", b"\x00" * 8]))),
    msgpack.packb(msgpack.ExtType(1, codec.packb([[-1], "float32", b""]))),
    msgpack.packb(msgpack.ExtType(1, codec.packb(["x", "float32", b""]))),
    msgpack.packb(msgpack.ExtType(3, codec.packb([[2], "float32", b"\x00" * 8]))),
    msgpack.packb(msgpack.ExtType(2, codec.packb(["a", 1.0]))),
    codec.packb({"a": {"__msgpack_chunked_array__": True, "shape": {"0": 3},
                       "chunks": {"1": np.zeros(3, np.float32)}}}),
], ids=["deep", "array32", "str32", "utf8", "list-key", "c1", "short-array", "dtype",
        "negative-dim", "shape-type", "npscalar-shape", "complex", "chunks"])
def test_corrupt_structures_raise_value_error(data):
    with pytest.raises(ValueError):
        codec.restore(data)


def test_unknown_extension_types_come_back_as_ext_type():
    data = msgpack.packb(msgpack.ExtType(42, b"abc"))
    assert codec.unpackb(data) == msgpack.unpackb(data) == (42, b"abc")
