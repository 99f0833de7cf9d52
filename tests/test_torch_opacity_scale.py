"""PyTorch port, K5c-f32 (the f32 tier's scale-only opacity re-bake): the
plain versions of `pack_alpha_scale_parts` and `apply_opacity_scale` held
against icon_rt_tpu/ops/fast.py on the same cells and transfer function,
and the re-bake against the full K5a bake."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icon_rt_tpu.data import synthetic as jsyn
from icon_rt_tpu.models.cells import build_cells as jbuild_cells
from icon_rt_tpu.models.cells import compute_stats as jstats
from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
from icon_rt_tpu.ops import fast as jfast
from icon_rt_tpu_torch import interop
from icon_rt_tpu_torch.ops import fast

torch.set_num_threads(1)

SCALES = [0.0, 0.37, 1.0, 3.5]


@pytest.fixture(scope="module")
def scene():
    """A subdiv 3 x 6 icosphere with a TF range wider than the data (values
    fall on both clamps of the LUT) in both packages."""
    ds = jsyn.icosphere(3, 6)
    st = jstats(ds)
    lo, hi = (float(v) for v in st.data_range)
    tf = jmake_tf(value_range=(lo - 0.1 * (hi - lo), hi + 0.05 * (hi - lo)),
                  opacity_scale=0.8)
    cells = jbuild_cells(ds)
    return dict(jcells=cells, jtf=tf, cells=interop.cells(cells),
                tf=interop.transfunc(tf))


def _with_scale(tf, s):
    return tf._replace(opacity_scale=torch.tensor(np.float32(s)))


def test_torch_alpha_scale_parts_vs_jax(scene):
    """(A, B) bit for bit equal to JAX's: each is one LUT entry times a
    weight (XLA's one-hot sum selects the entry exactly)."""
    a_j, b_j = jfast.pack_alpha_scale_parts(scene["jcells"], scene["jtf"])
    a_t, b_t = fast.pack_alpha_scale_parts(scene["cells"], scene["tf"])
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("s", SCALES)
def test_torch_apply_opacity_scale_vs_jax(scene, s):
    """The re-derived alpha half within 1 ULP of JAX's (XLA contracts
    a + b * s into an FMA, the port rounds the product first: measured 1
    ULP on 921 (s = 0.37) and 1551 (s = 3.5) of the 40,960 entries, 0 for
    s = 0 and 1); the height half untouched, updated in place."""
    jp = jfast.pack_cells(scene["jcells"], scene["jtf"])
    parts_j = jfast.pack_alpha_scale_parts(scene["jcells"], scene["jtf"])
    want = np.asarray(jfast.apply_opacity_scale(jp, parts_j,
                                                jnp.float32(s)).prof)
    packed = interop.packed_cells(jp)
    heights = packed.prof[:, :32].clone()
    parts = fast.pack_alpha_scale_parts(scene["cells"], scene["tf"])
    out = fast.apply_opacity_scale(packed, parts, torch.tensor(np.float32(s)))
    assert out is packed
    got = packed.prof.numpy()
    assert torch.equal(packed.prof[:, :32], heights)
    ulp = np.abs(got[:, 32:].view(np.int32).astype(np.int64)
                 - want[:, 32:].view(np.int32).astype(np.int64))
    assert ulp.max() <= 1, ulp.max()


@pytest.mark.parametrize("s", SCALES)
def test_torch_scale_only_rebake_equals_full_bake(scene, s):
    """A scale-only edit reproduces a full K5a bake at the new scale bit for
    bit: postClassify's alpha a1*frac + a2*(1-frac)*scale is affine in the
    scale and both round it in the same order."""
    cells, tf = scene["cells"], scene["tf"]
    packed = fast.pack_cells(cells, tf)
    parts = fast.pack_alpha_scale_parts(cells, tf)
    tf2 = _with_scale(tf, s)
    fast.apply_opacity_scale(packed, parts, tf2.opacity_scale)
    prof, rgb = fast.classify_bake(cells, tf2)
    assert torch.equal(packed.prof, prof)
    assert torch.equal(packed.rgb, rgb)


def test_torch_opacity_scale_rejects_bad_inputs(scene):
    cells, tf = scene["cells"], scene["tf"]
    packed = fast.pack_cells(cells, tf)
    a, b = fast.pack_alpha_scale_parts(cells, tf)
    with pytest.raises(ValueError):
        fast.pack_alpha_scale_parts(cells._replace(value=cells.value.double()),
                                    tf)
    with pytest.raises(ValueError):
        fast.apply_opacity_scale(packed, (a[:-1], b), tf.opacity_scale)
    with pytest.raises(ValueError):
        fast.apply_opacity_scale(packed, (a, b), tf.opacity_scale.reshape(1))
