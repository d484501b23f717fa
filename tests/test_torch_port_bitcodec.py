"""The native host codec (``ldmseg_torch/data/native``, built here with
g++) and the device codec (``ldmseg_torch/ops/bits.py:encode_bits`` /
``decode_bits``) against the numpy codec and the JAX package's.

Every comparison is exact: the codecs compute integers and copy floats.
The frames are KITTI-size (375x1242) id maps, with the ignore label, ids
above ``2**n - 1`` (their high bits drop) and the all-ones code.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.data import native as jnative  # noqa: E402
from ldmseg_tpu.ops import bits as jbits  # noqa: E402
from ldmseg_torch.data import native  # noqa: E402
from ldmseg_torch.data.transforms import encode_bits_host  # noqa: E402
from ldmseg_torch.ops import bits  # noqa: E402

HW = (375, 1242)


def _ids(seed, high=40):
    return np.random.RandomState(seed).randint(0, high, HW).astype(np.int64)


def test_native_codec_builds_into_the_build_directory():
    path = native.build()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "ldmseg_torch"
    assert native.library_path() == path
    assert native.get_lib() is native.get_lib()


@pytest.mark.parametrize("num_bits,ignore_label,fill", [
    (7, 0, 0.5), (5, 255, 0.25), (16, None, 0.5)])
def test_native_encode_equals_numpy_and_jax(num_bits, ignore_label, fill):
    x = _ids(num_bits, high=300)
    x[:4, :4] = 2 ** num_bits - 1  # the all-ones code
    ours = native.encode_bits_native(x, num_bits, ignore_label, fill)
    ref, _ = bits.encode_bits_np(x, num_bits, ignore_label, fill)
    assert ours.dtype == np.float32 and ours.shape == HW + (num_bits,)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        ours, jnative.encode_bits_native(x, num_bits, ignore_label, fill))
    # the readers' entry point is the native pass
    np.testing.assert_array_equal(
        encode_bits_host(x, num_bits, ignore_label, fill), ref)


@pytest.mark.parametrize("invalid_to_zero", [True, False])
def test_native_decode_and_remap_equal_numpy_and_jax(invalid_to_zero):
    x = _ids(3)
    b = 2.0 * bits.encode_bits_np(x, 6)[0] - 1.0
    b[:8, :8] = 1.0  # the all-ones code
    ours = native.decode_bits_native(b, invalid_to_zero)
    np.testing.assert_array_equal(
        ours, bits.decode_bits_np(b, invalid_to_zero=invalid_to_zero))
    np.testing.assert_array_equal(
        ours, jnative.decode_bits_native(b, invalid_to_zero))
    lut = np.random.RandomState(4).randint(0, 19, 35).astype(np.int32)
    np.testing.assert_array_equal(native.remap_lut_native(x, lut, 255),
                                  jnative.remap_lut_native(x, lut, 255))


def test_native_codec_refuses_what_the_c_side_refuses():
    with pytest.raises(ValueError, match="bits must be 1..31"):
        native.encode_bits_native(_ids(0)[:2, :2], 40)


@pytest.mark.parametrize("num_bits,ignore_label", [(7, 0), (5, None)])
def test_device_codec_equals_jax(num_bits, ignore_label):
    x = _ids(num_bits)[:64, :96].astype(np.int32)
    ours, ign = bits.encode_bits(torch.from_numpy(x), num_bits, ignore_label)
    ref, jign = jbits.encode_bits(jnp.asarray(x), num_bits, ignore_label)
    assert ours.dtype == torch.float32 and ign.dtype == torch.bool
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ign.numpy(), np.asarray(jign))
    analog = 2.0 * np.asarray(ref) - 1.0
    for axis in (-1, 2):
        for invalid_to_zero in (True, False):
            got = bits.decode_bits(torch.from_numpy(analog), axis,
                                   invalid_to_zero)
            want = jbits.decode_bits(jnp.asarray(analog), axis,
                                     invalid_to_zero)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
