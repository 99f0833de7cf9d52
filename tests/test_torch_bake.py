"""PyTorch port, K5a (the TF-edit bake): the plain version against the JAX
package's pack_profile_rows, and pack_cells' test rows."""
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops.fast import pack_profile_rows, pack_test_rows
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.ops.fast import (_profile_rows_torch, classify_bake,
                                        pack_cells)

torch.set_num_threads(1)


def _ulp(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
                  - np.where(ib < 0, -(ib & 0x7FFFFFFF), ib))


@pytest.mark.parametrize("sub,layers,lut_seed,scale", [
    (2, 5, None, 1.0), (3, 8, 4, 0.35), (3, 7, 9, 2.5)])
def test_torch_classify_bake_plain_vs_jax(sub, layers, lut_seed, scale):
    """Heights (the first half of prof): bitwise.  Classified RGBA: within
    1 ULP — the JAX bake reads the LUT through a one-hot compare-sum that
    XLA may contract into FMAs (icon_rt_tpu/ops/fast.py:151-153), the port
    rounds every multiply and add."""
    jds = jsyn.icosphere(sub, layers)
    st = jstats(jds)
    lut = None if lut_seed is None else \
        np.random.default_rng(lut_seed).random((300, 4), np.float32)
    jtf = jmake_tf(lut, value_range=tuple(st.data_range), opacity_scale=scale)
    jc = jbuild_cells(jds)
    jprof, jrgb = (np.asarray(a) for a in pack_profile_rows(jc, jtf))
    tc, ttf = interop.cells(jc), interop.transfunc(jtf)
    tprof, trgb = _profile_rows_torch(tc.height, tc.value, tc.num_layers, ttf)
    tprof, trgb = tprof.numpy(), trgb.numpy()
    np.testing.assert_array_equal(tprof[:, :32], jprof[:, :32])
    assert _ulp(tprof[:, 32:], jprof[:, 32:]).max() <= 1
    assert _ulp(trgb, jrgb).max() <= 1
    # the wrapper runs the plain version for CPU tensors
    wprof, wrgb = classify_bake(tc, ttf)
    np.testing.assert_array_equal(wprof.numpy(), tprof)
    np.testing.assert_array_equal(wrgb.numpy(), trgb)
    packed = pack_cells(tc, ttf)
    np.testing.assert_array_equal(packed.test.numpy(),
                                  np.asarray(pack_test_rows(jc)))


def test_torch_classify_bake_rejects_bad_inputs():
    jds = jsyn.icosphere(1, 3)
    jc = jbuild_cells(jds)
    tc = interop.cells(jc)
    ttf = interop.transfunc(jmake_tf(value_range=(0.0, 1.0)))
    with pytest.raises(ValueError):
        classify_bake(tc._replace(value=tc.value.double()), ttf)
    with pytest.raises(ValueError):
        classify_bake(tc._replace(height=tc.height.t()), ttf)
    with pytest.raises(ValueError):
        classify_bake(tc._replace(num_layers=tc.num_layers.long()), ttf)
