"""PyTorch port, utilities: LCG, sRGB/RGBA8 packing, PNG IO, and the rule
that the port never imports jax or the JAX package."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from icon_rt_tpu.utils import color as jcolor
from icon_rt_tpu.utils.lcg import lcg_init as jlcg_init, lcg_next as jlcg_next
from icon_rt_tpu_torch.utils import color as tcolor
from icon_rt_tpu_torch.utils.lcg import (lcg_init, lcg_next, np_lcg_init,
                                         np_lcg_next)
from icon_rt_tpu_torch.utils.png import read_png, write_png
from test_lcg import GOLDEN

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def test_torch_lcg_golden_vectors():
    """Bitwise: the int64-masked tensor LCG reproduces the reference's
    LCG<4> golden states and draws."""
    s0 = torch.tensor([g[0] for g in GOLDEN], dtype=torch.int64)
    s1 = torch.tensor([g[1] for g in GOLDEN], dtype=torch.int64)
    st = lcg_init(s0, s1)
    assert st.tolist() == [g[2] for g in GOLDEN]
    for k in range(6):
        st, v = lcg_next(st)
        assert v.dtype == torch.float32
        assert v.tolist() == [float(np.float32(g[3][k])) for g in GOLDEN]
    assert st.tolist() == [g[4] for g in GOLDEN]


def test_torch_lcg_matches_numpy_and_jax_streams():
    """Bitwise over 10k random seed pairs x 8 draws: torch == numpy twin ==
    JAX."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2 ** 32, 10_000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 10_000, dtype=np.uint64).astype(np.uint32)
    st_t = lcg_init(torch.from_numpy(a.astype(np.int64)),
                    torch.from_numpy(b.astype(np.int64)))
    st_n = np_lcg_init(a, b)
    st_j = jlcg_init(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(st_t.numpy().astype(np.uint32), st_n)
    np.testing.assert_array_equal(st_n, np.asarray(st_j))
    for _ in range(8):
        st_t, v_t = lcg_next(st_t)
        st_n, v_n = np_lcg_next(st_n)
        st_j, v_j = jlcg_next(st_j)
        np.testing.assert_array_equal(st_t.numpy().astype(np.uint32), st_n)
        np.testing.assert_array_equal(v_t.numpy(), v_n)
        np.testing.assert_array_equal(v_n, np.asarray(v_j))


def test_torch_srgb_and_rgba_match_jax():
    """make_rgba: bitwise on the same inputs (out-of-range included).
    linear_to_srgb -> make_rgba, the framebuffer the user sees: bitwise.
    The f32 sRGB value itself: within 4 ULP — both sides round a libm
    pow(x, 1/2.4), and torch's CPU pow is not correctly rounded (measured
    up to 4 ULP from XLA's on 1.4% of inputs), which moves no 8-bit
    channel here."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.random(20_000, np.float32),
                        np.array([0.0, 0.0031308, 0.0031309, 1.0, 1.5,
                                  -0.2, 0.999], np.float32)])
    s_t = tcolor.linear_to_srgb(torch.from_numpy(x)).numpy()
    s_j = np.asarray(jcolor.linear_to_srgb(jnp.asarray(x)))
    ulp = np.abs(s_t.view(np.int32).astype(np.int64)
                 - s_j.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4, ulp.max()
    rgba = rng.random((5000, 4), np.float32) * 1.2 - 0.1
    p_t = tcolor.make_rgba(torch.from_numpy(rgba)).numpy().view(np.uint32)
    p_j = np.asarray(jcolor.make_rgba(jnp.asarray(rgba)))
    np.testing.assert_array_equal(p_t, p_j)
    lin = rng.random((20_000, 4), np.float32)
    srgb_t = torch.cat([tcolor.linear_to_srgb(torch.from_numpy(lin[:, :3])),
                        torch.from_numpy(lin[:, 3:])], dim=1)
    srgb_j = jnp.concatenate([jcolor.linear_to_srgb(jnp.asarray(lin[:, :3])),
                              jnp.asarray(lin[:, 3:])], axis=1)
    np.testing.assert_array_equal(
        tcolor.make_rgba(srgb_t).numpy().view(np.uint32),
        np.asarray(jcolor.make_rgba(srgb_j)))
    np.testing.assert_array_equal(tcolor.unpack_rgba(torch.from_numpy(
        p_t.view(np.int32))), jcolor.unpack_rgba(p_j))


def test_torch_png_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img[::-1])


def test_torch_port_never_imports_jax(tmp_path):
    """In a fresh interpreter: import every module of the port (the march,
    ops/march.py, the LOD module, data/lod.py, and the unstructured
    elements, ops/uelems.py and models/wedges.py, by name too; frame_lod
    picks its level, the wedge sampler and the intersectors run on a few
    points; the multi-device modules, parallel/ and data/animation.py, by
    name too, a one-process animation through them) and run tiny renders
    through the app, the Woodcock tracker, the march and the fast wedge
    tier (-mode 2), the preview tier and --samples auto; the front ends and
    ingest by name too -- apps/viewer_torch.py serving two frames,
    apps/interactive_demo_torch.py's session, scripts/e2e_netcdf_torch.py
    from NetCDF through the port's convert_icon to a PNG); neither jax nor
    icon_rt_tpu may load."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import importlib, pkgutil
import torch
torch.set_num_threads(1)
import icon_rt_tpu_torch
for m in pkgutil.walk_packages(icon_rt_tpu_torch.__path__, 'icon_rt_tpu_torch.'):
    importlib.import_module(m.name)
import icon_rt_tpu_torch.ops.march
from icon_rt_tpu_torch.data.lod import frame_lod
assert frame_lod(11, 'viewall', 1920, 1080) == 3
from icon_rt_tpu_torch.data.synthetic import icosphere
from icon_rt_tpu_torch.models.cells import build_cells
from icon_rt_tpu_torch.models.locator import build_locator
from icon_rt_tpu_torch.models.wedges import build_wedges, sample_wedges
from icon_rt_tpu_torch.ops.uelems import uelems_points
ds = icosphere(1, 2)
pos = torch.from_numpy(ds.height[:8, 1:2] * 1.0).float() * torch.tensor(
    [[0.3, 0.5, 0.81]])
hit, val = sample_wedges(build_cells(ds), build_wedges(ds),
                         build_locator(ds), pos)
assert hit.shape == (8,)
ins, v = uelems_points(torch.zeros(2, 3), torch.rand(2, 8, 3),
                       torch.rand(2, 8))
import functools
import icon_rt_tpu_torch.data.animation
import icon_rt_tpu_torch.parallel.scene_shard
import icon_rt_tpu_torch.parallel.sharded
from icon_rt_tpu_torch.parallel import ranks
got = ranks.animate_job(0, 1, None, torch.device('cpu'), inputs=functools.partial(
    ranks.synthetic_scene, 'q', 1, 2, 16, 16), tier='q', width=16, height=16,
    samples_per_frame=1, mesh=False)
assert got['frames'][0].shape == (256,)
from icon_rt_tpu_torch import app
for extra, out in (([], 'x'), (['--march'], 'm'), (['-mode', '2'], 'w'),
                   (['--preview', '4', '--samples', 'auto'], 'p')):
    assert app.main(['--device', 'cpu', '--synthetic', '1:2', '--size', '16',
                     '16', '--sample-limit', '2', *extra,
                     '-o', {str(tmp_path)!r} + '/' + out]) == 0
import icon_rt_tpu_torch.data.netcdf
import icon_rt_tpu_torch.tools.convert_icon
import icon_rt_tpu_torch.utils.autosize
sys.path[:0] = [{ROOT!r} + '/apps', {ROOT!r} + '/scripts']
import e2e_netcdf_torch, interactive_demo_torch, viewer_torch
assert e2e_netcdf_torch.main(['--subdiv', '1', '--levels', '2', '--size',
                              '16', '16', '--sample-limit', '1', '--device',
                              'cpu', '-o', {str(tmp_path)!r} + '/e']) == 0
assert interactive_demo_torch.main(['--synthetic', '1:2', '--size', '16',
                                    '--device', 'cpu',
                                    '-o', {str(tmp_path)!r} + '/demo']) == 0
pl = app.build(['--device', 'cpu', '--synthetic', '1:2', '--size', '16',
                '16'])
st = viewer_torch.serve(pl, port=0, max_frames=2)
assert st.frame_id == 1 and st.png[1:4] == b'PNG'
bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')
       or m == 'icon_rt_tpu' or m.startswith('icon_rt_tpu.')]
assert not bad, bad
print('CLEAN')
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "CLEAN" in res.stdout
    assert os.path.exists(tmp_path / "x.png")
    assert os.path.exists(tmp_path / "m.png")
    assert os.path.exists(tmp_path / "w.png")
    assert os.path.exists(tmp_path / "p.png")
    assert os.path.exists(tmp_path / "e.png")
    assert len(os.listdir(tmp_path / "demo")) == 7
