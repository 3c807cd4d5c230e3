"""The port's object serializer (``ray_tpu_torch.core.serialization``) held
against the JAX package's (``ray_tpu.core.serialization``).

- numpy, Arrow and plain Python values pack to the same wire format and
  decode equal in both, each package decoding the other's payloads;
- a ``torch.Tensor`` travels as one out-of-band host buffer and decodes to
  the values a ``jax.Array`` of the same data decodes to in the JAX
  package: fp32, bf16 (sent as 16-bit integers: numpy has no bf16),
  non-contiguous and 0-d tensors, parameters, alone and inside nested
  containers, through both the zero-copy and the copying read;
- the placement rule at load: a tensor that left from ``cuda`` lands on the
  CPU in a process without a card (this one), any other on the CPU;
- ``ObjectRef``s inside a value are captured and come back as borrowed
  refs with the same ids, as in the JAX package.
"""

import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pyarrow as pa
import pytest
import torch

from ray_tpu.core import serialization as jax_ser
from ray_tpu_torch.core import serialization as port_ser

SERIALIZERS = {"ray_tpu": jax_ser, "ray_tpu_torch": port_ser}


def _roundtrip(ser, value, zero_copy):
    payload, refs = ser.pack(value)
    return ser.unpack(memoryview(payload), zero_copy=zero_copy), payload, refs


def _tensor_cases():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((6, 10)).astype(np.float32)
    return {
        "fp32": (torch.from_numpy(base.copy()), base),
        "bf16": (torch.from_numpy(base.copy()).to(torch.bfloat16),
                 base.astype(ml_dtypes.bfloat16)),
        "non_contiguous": (torch.from_numpy(base.copy())[:, ::3].t(), base[:, ::3].T),
        "zero_d": (torch.tensor(2.5), np.float32(2.5)),
        "int64": (torch.arange(12).reshape(3, 4), np.arange(12).reshape(3, 4)),
        "empty": (torch.zeros(0, 5), np.zeros((0, 5), np.float32)),
    }


@pytest.mark.parametrize("zero_copy", [True, False], ids=["zero_copy", "copy"])
@pytest.mark.parametrize("case", list(_tensor_cases()))
def test_tensor_decodes_like_a_jax_array(case, zero_copy):
    """The port's tensor and the JAX package's jax.Array of the same data,
    each through its own serializer, decode to equal values, dtype and
    shape; the tensor's bytes ride out of band, never through torch's
    storage pickling."""
    tensor, arr = _tensor_cases()[case]
    out, payload, _ = _roundtrip(port_ser, tensor, zero_copy)
    ref, _, _ = _roundtrip(jax_ser, jnp.asarray(arr), zero_copy)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == tensor.dtype and tuple(out.shape) == tuple(np.shape(ref))
    assert torch.equal(out, tensor)
    got = out.float().numpy() if out.dtype == torch.bfloat16 else out.numpy()
    np.testing.assert_array_equal(got, np.asarray(ref).astype(got.dtype))
    meta, buffers, _ = port_ser.serialize(tensor)
    assert b"_rebuild_tensor" not in meta and b"torch.storage" not in meta
    assert [b.raw().nbytes for b in buffers] == [tensor.numel() * tensor.element_size()]
    sent = port_ser._reduce_tensor(tensor)[1][0]  # the host array that rides out of band
    assert sent.dtype == (np.uint16 if case == "bf16" else got.dtype)


def test_decoded_tensor_owns_its_memory():
    """A loaded CPU tensor never aliases the payload: a write to it leaves
    the stored bytes (and every other reader's copy) as they were."""
    t = torch.arange(8, dtype=torch.float32)
    payload, _ = port_ser.pack(t)
    buf = bytearray(payload)
    a = port_ser.unpack(memoryview(buf), zero_copy=True)
    a += 100
    b = port_ser.unpack(memoryview(buf), zero_copy=True)
    assert torch.equal(b, t)


def test_tensors_inside_nested_containers():
    t32 = torch.randn(3, 4)
    t16 = torch.randn(5).to(torch.bfloat16)
    value = {"a": [t32, (t16, {"deep": t32[1]})], "n": np.arange(3), "s": "x"}
    out, _, _ = _roundtrip(port_ser, value, True)
    assert torch.equal(out["a"][0], t32)
    assert out["a"][1][0].dtype == torch.bfloat16 and torch.equal(out["a"][1][0], t16)
    assert torch.equal(out["a"][1][1]["deep"], t32[1])
    np.testing.assert_array_equal(out["n"], np.arange(3))
    assert out["s"] == "x"
    # the JAX package's counterpart: the same structure of jax.Arrays
    jvalue = {"a": [jnp.asarray(t32.numpy()), (jnp.asarray(t16.float().numpy()),)]}
    jout, _, _ = _roundtrip(jax_ser, jvalue, True)
    np.testing.assert_array_equal(np.asarray(jout["a"][0]), out["a"][0].numpy())
    np.testing.assert_array_equal(np.asarray(jout["a"][1][0]), out["a"][1][0].float().numpy())


def test_parameter_and_requires_grad_survive():
    p = torch.nn.Parameter(torch.randn(4, 2))
    g = torch.randn(3).requires_grad_(True)
    out, _, _ = _roundtrip(port_ser, [p, g], True)
    assert type(out[0]) is torch.nn.Parameter and out[0].requires_grad
    assert torch.equal(out[0].detach(), p.detach())
    assert type(out[1]) is torch.Tensor and out[1].requires_grad and out[1].is_leaf


def test_cuda_tensor_lands_on_the_cpu_without_a_card():
    """The placement rule's second half, as a process with no card sees it:
    a tensor that left from cuda loads on the CPU."""
    arr = np.arange(6, dtype=np.uint16)
    t = port_ser._reconstruct_tensor(arr, "bfloat16", True, "cuda", False, False)
    assert t.device.type == "cpu" and t.dtype == torch.bfloat16
    assert torch.equal(t.view(torch.int16), torch.from_numpy(arr.view(np.int16)))


@pytest.mark.parametrize("producer", list(SERIALIZERS))
@pytest.mark.parametrize("kind", ["numpy", "arrow", "plain"])
def test_values_decode_equal_across_packages(producer, kind):
    """numpy, Arrow and plain values: each package's payload decodes, in
    both packages, to a value equal to the one sent."""
    rng = np.random.default_rng(1)
    if kind == "numpy":
        value = {"x": rng.standard_normal((64, 3)).astype(np.float32),
                 "i": np.arange(10, dtype=np.int64)[::2]}
    elif kind == "arrow":
        value = pa.table({"k": np.arange(100, dtype=np.int64),
                          "v": rng.standard_normal(100),
                          "s": [f"r{i}" for i in range(100)]})
    else:
        value = {"a": [1, 2.5, None, "txt", b"\x00\x01"], "b": (True, {"n": 3})}
    payload, _ = SERIALIZERS[producer].pack(value)
    for consumer in SERIALIZERS.values():
        out = consumer.unpack(memoryview(payload), zero_copy=True)
        if kind == "numpy":
            assert set(out) == set(value)
            for k in value:
                assert out[k].dtype == value[k].dtype
                np.testing.assert_array_equal(out[k], value[k])
        elif kind == "arrow":
            assert out.equals(value)
        else:
            assert out == value


@pytest.mark.parametrize("kind", ["numpy", "arrow"])
def test_same_wire_bytes_for_the_same_value(kind):
    """The two serializers carry numpy and Arrow values in the same
    out-of-band buffers; a numpy payload is the same bytes whole (an Arrow
    one names each package's own decoder in its pickle)."""
    value = (np.arange(1000, dtype=np.float64) if kind == "numpy"
             else pa.table({"k": np.arange(50, dtype=np.int32)}))
    jax_buffers = [bytes(b.raw()) for b in jax_ser.serialize(value)[1]]
    port_buffers = [bytes(b.raw()) for b in port_ser.serialize(value)[1]]
    assert jax_buffers == port_buffers and len(port_buffers) == 1
    if kind == "numpy":
        assert jax_ser.pack(value)[0] == port_ser.pack(value)[0]


def test_arrow_decode_counters_agree():
    table = pa.table({"k": np.arange(1000, dtype=np.int64), "v": np.ones(1000)})
    diffs = []
    for ser in SERIALIZERS.values():
        before = ser.arrow_decode_snapshot()
        payload, _ = ser.pack(table)
        assert ser.unpack(memoryview(payload)).equals(table)
        after = ser.arrow_decode_snapshot()
        diffs.append({k: after[k] - before[k] for k in after})
    assert diffs[0] == diffs[1] and diffs[1]["zero_copy_bytes"] > 0


@pytest.fixture
def both_local_runtimes():
    import ray_tpu
    import ray_tpu_torch

    pkgs = (ray_tpu, ray_tpu_torch)
    for p in pkgs:
        if p.is_initialized():
            p.shutdown()
    for p in pkgs:
        p.init(num_cpus=1)
    yield pkgs
    for p in pkgs:
        p.shutdown()


def test_object_ref_capture(both_local_runtimes):
    """Refs inside a value are captured at pack time and decode as borrowed
    refs with the same id, in both packages."""
    results = []
    for pkg, ser in zip(both_local_runtimes, SERIALIZERS.values()):
        r1, r2 = pkg.put(1), pkg.put(2)
        payload, refs = ser.pack({"refs": [r1, (r2,)], "t": 3})
        assert [r.id for r in refs] == [r1.id, r2.id]
        out = ser.unpack(memoryview(payload))
        assert type(out["refs"][0]) is type(r1)
        assert out["refs"][0].id == r1.id and out["refs"][1][0].id == r2.id
        assert pkg.get(out["refs"][1][0]) == 2
        results.append((len(refs), out["t"]))
    assert results[0] == results[1]


def test_importing_the_serializer_imports_no_torch():
    """Daemons and CPU workers load the serializer without torch: a tensor
    can only reach it once the process imported torch itself."""
    code = ("import sys; import ray_tpu_torch.core.serialization, ray_tpu_torch; "
            "print('torch' in sys.modules, 'jax' in sys.modules, 'ray_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, check=True)
    assert out.stdout.split() == ["False", "False", "False"]
