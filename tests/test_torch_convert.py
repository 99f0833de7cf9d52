"""PyTorch port, data ingest: icon_rt_tpu_torch.data.netcdf and
icon_rt_tpu_torch.tools.convert_icon against the JAX package's on the same
NetCDF files (written by scipy.io), the converter's outputs byte for byte,
and scripts/e2e_netcdf_torch.py's DWD-layout inputs against
scripts/e2e_netcdf.py's."""
import os
import sys

import numpy as np
import pytest

scipy_io = pytest.importorskip("scipy.io")

from icon_rt_tpu.data import netcdf as jnetcdf  # noqa: E402
from icon_rt_tpu.tools import convert_icon as jci  # noqa: E402
from icon_rt_tpu_torch.data import netcdf  # noqa: E402
from icon_rt_tpu_torch.data.icfile import read_ic  # noqa: E402
from icon_rt_tpu_torch.tools import convert_icon as ci  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def _write_nc(path, dims, variables, attrs=None, version=1):
    f = scipy_io.netcdf_file(path, "w", version=version)
    for n, s in dims.items():
        f.createDimension(n, s)
    for name, (dimnames, data) in variables.items():
        v = f.createVariable(name, data.dtype.newbyteorder(">"), dimnames)
        v[:] = data
    for k, v in (attrs or {}).items():
        setattr(f, k, v)
    f.close()


def _nc_file(tmp_path, kind):
    """A seeded NetCDF file of one kind: CDF-1 with int, float and double
    variables and global attributes, CDF-2 (64-bit offsets), or record
    variables over an unlimited dimension (two of them, so the records
    interleave, and a lone one)."""
    rs = np.random.RandomState(3)
    p = str(tmp_path / f"{kind}.nc")
    if kind in ("cdf1", "cdf2"):
        _write_nc(p, {"cell": 12, "nv": 3},
                  {"clat_vertices": (("cell", "nv"),
                                     rs.rand(12, 3).astype(np.float32)),
                   "ids": (("cell",), np.arange(12, dtype=np.int32) * 2),
                   "hsurf": (("cell",), rs.rand(12)),
                   "level": (("nv",), np.arange(3, dtype=np.int16))},
                  attrs={"title": "icon grid", "grid_level": 7},
                  version=1 if kind == "cdf1" else 2)
        return p
    f = scipy_io.netcdf_file(p, "w")
    f.createDimension("time", None)
    f.createDimension("cell", 5)
    names = ("HHL", "pres") if kind == "records" else ("HHL",)
    for k, name in enumerate(names):
        v = f.createVariable(name, np.dtype(">f4"), ("time", "cell"))
        for rec in range(3):
            v[rec] = rs.rand(5).astype(np.float32) + 100 * k
    f.close()
    return p


@pytest.mark.parametrize("kind", ["cdf1", "cdf2", "records", "one_record"])
def test_torch_netcdf_reader_matches_jax(tmp_path, kind):
    """The port's reader and JAX's agree on the header (dimensions,
    attributes, the record count, every variable's dims, shape and dtype)
    and on every variable's values, and both equal scipy's."""
    p = _nc_file(tmp_path, kind)
    if kind == "cdf2":
        assert open(p, "rb").read(4)[3] == 2
    t, j = netcdf.Dataset(p), jnetcdf.Dataset(p)
    assert t.dimensions == j.dimensions and t.numrecs == j.numrecs
    assert t.attributes.keys() == j.attributes.keys()
    for k, v in t.attributes.items():
        np.testing.assert_array_equal(v, j.attributes[k])
    assert t.variables.keys() == j.variables.keys()
    ref = scipy_io.netcdf_file(p, "r", mmap=False)
    for name, v in t.variables.items():
        w = j.variables[name]
        assert (v.dims, v.shape, v.dtype, v.is_record) == \
            (w.dims, w.shape, w.dtype, w.is_record)
        assert name in t and "no_such_variable" not in t
        got = t[name]
        assert got.dtype == j[name].dtype and got.dtype.isnative
        np.testing.assert_array_equal(got, j[name])
        np.testing.assert_array_equal(got, ref.variables[name][:])
    ref.close()


def test_torch_netcdf_rejects_other_files(tmp_path):
    p = str(tmp_path / "h5.nc")
    with open(p, "wb") as f:
        f.write(b"\x89HDF\r\n\x1a\n" + bytes(64))
    with pytest.raises(ValueError, match="not a NetCDF classic"):
        netcdf.Dataset(p)
    with pytest.raises((RuntimeError, ImportError, OSError)):
        ci._open(p)


def _icon_inputs(tmp_path, ncell=8, nlev=4, transposed=False, seed=0):
    """tests/test_convert.py's DWD-layout inputs: corner grid (cell, nv) or
    (nv, cell), HSURF, nlev + 1 HHL files and nlev 'pres' files."""
    rs = np.random.RandomState(seed)
    shape = (3, ncell) if transposed else (ncell, 3)
    dims = ("nv", "cell") if transposed else ("cell", "nv")
    lat = np.deg2rad(rs.uniform(-60, 60, shape)).astype(np.float32)
    lon = np.deg2rad(rs.uniform(-170, 170, shape)).astype(np.float32)
    hgrid = str(tmp_path / "grid.nc")
    _write_nc(hgrid, dict(zip(dims, shape)),
              {"clat_vertices": (dims, lat), "clon_vertices": (dims, lon)})
    hsurf = str(tmp_path / "hsurf.nc")
    _write_nc(hsurf, {"cell": ncell}, {"HSURF": (("cell",), rs.uniform(
        0, 500, ncell).astype(np.float32))})
    hhl, data = [], []
    for k in rs.permutation(nlev + 1):      # any order: the converter sorts
        p = str(tmp_path / f"hhl{k}.nc")
        h = np.full(ncell, 1000.0 * (k + 1), np.float32) \
            + rs.uniform(0, 50, ncell).astype(np.float32)
        _write_nc(p, {"cell": ncell}, {"HHL": (("cell",), h)})
        hhl.append(p)
    for k in range(nlev):
        p = str(tmp_path / f"pres{k}.nc")
        d = rs.uniform(900, 1100, ncell).astype(np.float32)
        _write_nc(p, {"cell": ncell}, {"pres": (("cell",), d)})
        data.append(p)
    return hgrid, hsurf, hhl, data


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


#: the converter's cases of tests/test_convert.py: (inputs, CLI flags, the
#: outputs compared byte for byte)
CONVERT_CASES = {
    "ic": (dict(), [], [".ic"]),
    "cli": (dict(), ["--umesh", "--wedges"], [".ic", ".umesh", ".wedges"]),
    "split": (dict(ncell=3, nlev=40), [], [".ic"]),
    "max-layers": (dict(ncell=3), ["--max-layers", "2"], [".ic"]),
    "transposed": (dict(ncell=5, transposed=True), [], [".ic"]),
    "umesh": (dict(ncell=6, nlev=3), ["--umesh", "--no-ic"], [".umesh"]),
    "wedges": (dict(ncell=6, nlev=3), ["--wedges", "--no-ic"], [".wedges"]),
}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_torch_convert_matches_jax(tmp_path, case):
    """The convert_icon CLI of both packages on the same files writes the
    same bytes: the .ic (layers split past LMAX - 1 = 31 into two records
    a column, --max-layers, the (nv, cell) corner layout) and the wedge
    soups (--umesh, --wedges)."""
    kw, flags, exts = CONVERT_CASES[case]
    hgrid, hsurf, hhl, data = _icon_inputs(tmp_path, **kw)
    argv = ["-hgrid", hgrid, "-hsurf", hsurf, "-hhl", *hhl, "-data", *data,
            *flags]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert ci.main([*argv, "-o", out_t]) == 0
    assert jci.main([*argv, "-o", out_j]) == 0
    for ext in exts:
        assert _bytes(out_t + ext) == _bytes(out_j + ext), ext
    for ext in {".ic", ".umesh", ".wedges"} - set(exts):
        assert not os.path.exists(out_t + ext)
    if ".ic" in exts:
        ds = read_ic(out_t + ".ic")
        ncell, nlev = kw.get("ncell", 8), kw.get("nlev", 4)
        if case == "split":
            assert ds.num_cells == 2 * ncell
            assert sorted(set(ds.num_layers.tolist())) == [9, 31]
        else:
            nl = 2 if case == "max-layers" else nlev
            assert ds.num_cells == ncell and (ds.num_layers == nl).all()
        h = ds.height
        for i in range(ds.num_cells):
            assert (np.diff(h[i, :ds.num_layers[i] + 1]) > 0).all()
        v = ds.value[ds.value > 0]
        assert v.max() <= 1.0


def test_torch_convert_functions_match_jax(tmp_path):
    """convert, wedge_soup, read_umesh and _corner_layout equal JAX's: the
    ICDataset fields, the soup's arrays, and read_umesh of a file written
    by the other package (a round trip both ways)."""
    hgrid, hsurf, hhl, data = _icon_inputs(tmp_path, ncell=7, nlev=5)
    dt, dj = ci.convert(hgrid, hsurf, hhl, data), \
        jci.convert(hgrid, hsurf, hhl, data)
    for f in ("lat", "lon", "num_layers", "height", "value"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
    for a, b in zip(ci.wedge_soup(dt, 20.0), jci.wedge_soup(dj, 20.0)):
        np.testing.assert_array_equal(a, b)
    ci.write_umesh(str(tmp_path / "t.umesh"), dt, attr_name="pres")
    jci.write_umesh(str(tmp_path / "j.umesh"), dj, attr_name="pres")
    for name in ("t", "j"):
        got = ci.read_umesh(str(tmp_path / f"{name}.umesh"))
        want = jci.read_umesh(str(tmp_path / f"{name}.umesh"))
        assert got.keys() == want.keys() and got["attr_name"] == "pres"
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    verts, scalars, indices = ci.wedge_soup(dt)
    um = ci.read_umesh(str(tmp_path / "t.umesh"))
    np.testing.assert_array_equal(um["vertices"], verts)
    np.testing.assert_array_equal(um["wedges"], indices)
    np.testing.assert_array_equal(um["values"], scalars)
    x = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(ci._corner_layout(x.T, 4),
                                  jci._corner_layout(x.T, 4))
    with pytest.raises(ValueError):
        ci._corner_layout(x, 5)
    with pytest.raises(ValueError, match="umesh"):
        ci.read_umesh(str(tmp_path / "hsurf.nc"))


def test_torch_e2e_inputs_match_jax(tmp_path):
    """scripts/e2e_netcdf_torch.py writes the same DWD-layout NetCDF bytes
    as scripts/e2e_netcdf.py (subdivision 2, 4 levels), and the port's
    convert_icon CLI turns them into the same .ic as JAX's; the .ic holds
    one column a cell with `levels` layers."""
    import e2e_netcdf
    import e2e_netcdf_torch
    ins_t = e2e_netcdf_torch.make_netcdf_inputs(str(tmp_path / "t"), 2, 4)
    ins_j = e2e_netcdf.make_netcdf_inputs(str(tmp_path / "j"), 2, 4)
    flat = lambda ins: [ins[0], ins[1], *ins[2], *ins[3]]
    assert len(flat(ins_t)) == 2 + 5 + 4
    for a, b in zip(flat(ins_t), flat(ins_j)):
        assert _bytes(a) == _bytes(b), a
    out_t, out_j = str(tmp_path / "t" / "r2b2"), str(tmp_path / "j" / "r2b2")
    assert ci.main(e2e_netcdf_torch.convert_argv(ins_t, out_t)) == 0
    assert jci.main(e2e_netcdf_torch.convert_argv(ins_j, out_j)) == 0
    assert _bytes(out_t + ".ic") == _bytes(out_j + ".ic")
    ds = read_ic(out_t + ".ic")
    assert ds.num_cells == 20 * 4 ** 2 and (ds.num_layers == 4).all()
