"""Minimal numpy reader for NetCDF classic files (CDF-1, CDF-2, CDF-5).

The reference converter links libnetcdf (ref: tools/convert_icon.cpp:60-118
nc_open/nc_inq_* helpers).  The DWD ICON files it consumes are NetCDF
classic, a simple documented binary format, so this module parses it
directly with numpy and `struct`: dimensions, attributes, non-record and
record variables, CDF-2 (64-bit offsets) and CDF-5 (64-bit sizes).  The
converter only reads NetCDF, so there is no writer.  netCDF-4/HDF5 files
go through the optional netCDF4 package (tools/convert_icon.py `_open`).
"""
from __future__ import annotations

import struct

import numpy as np

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

_TYPEMAP = {
    1: np.dtype(">i1"), 2: np.dtype("S1"), 3: np.dtype(">i2"),
    4: np.dtype(">i4"), 5: np.dtype(">f4"), 6: np.dtype(">f8"),
    7: np.dtype(">u1"), 8: np.dtype(">u2"), 9: np.dtype(">u4"),
    10: np.dtype(">i8"), 11: np.dtype(">u8"),
}


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def take(self, n):
        out = self.d[self.p:self.p + n]
        self.p += n
        return out

    def i4(self):
        return struct.unpack(">i", self.take(4))[0]

    def i8(self):
        return struct.unpack(">q", self.take(8))[0]

    def nonneg(self, wide):
        return self.i8() if wide else self.i4()

    def name(self):
        n = self.i4()
        s = self.take(n).decode("utf-8", "replace")
        self.p += (4 - n % 4) % 4  # padding
        return s


class Variable:
    def __init__(self, name, dims, shape, dtype, vsize, begin, is_record):
        self.name, self.dims, self.shape = name, dims, shape
        self.dtype, self.vsize, self.begin = dtype, vsize, begin
        self.is_record = is_record


class Dataset:
    """Read-only NetCDF classic dataset: `ds.dimensions`, `ds.variables`,
    `ds.attributes`, `ds[name]` -> numpy array (native byte order)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:3] != b"CDF":
            raise ValueError(f"{path}: not a NetCDF classic file")
        version = data[3]
        if version not in (1, 2, 5):
            raise ValueError(f"{path}: unsupported CDF version {version}")
        off64 = version >= 2   # 64-bit begin offsets
        wide = version == 5    # 64-bit sizes
        r = _Reader(data)
        r.p = 4
        self.numrecs = r.nonneg(wide)
        self._data = data

        self.dimensions: dict[str, int] = {}
        self._dim_names: list[str] = []
        tag = r.i4()
        ndims = r.nonneg(wide)
        if tag == _NC_DIMENSION:
            for _ in range(ndims):
                nm = r.name()
                self.dimensions[nm] = r.nonneg(wide)
                self._dim_names.append(nm)

        def read_atts():
            atts = {}
            t = r.i4()
            n = r.nonneg(wide)
            if t == _NC_ATTRIBUTE:
                for _ in range(n):
                    nm = r.name()
                    tp = r.i4()
                    cnt = r.nonneg(wide)
                    dt = _TYPEMAP[tp]
                    raw = r.take(dt.itemsize * cnt)
                    r.p += (4 - (dt.itemsize * cnt) % 4) % 4
                    atts[nm] = (raw.decode("utf-8", "replace") if tp == 2
                                else np.frombuffer(raw, dt))
            return atts

        self.attributes = read_atts()

        self.variables: dict[str, Variable] = {}
        tag = r.i4()
        nvars = r.nonneg(wide)
        if tag == _NC_VARIABLE:
            for _ in range(nvars):
                nm = r.name()
                nd = r.nonneg(wide)
                dimids = [r.nonneg(wide) for _ in range(nd)]
                read_atts()
                tp = r.i4()
                vsize = r.nonneg(wide)
                begin = r.i8() if off64 else r.i4()
                dims = [self._dim_names[i] for i in dimids]
                shape = tuple(self.dimensions[d] for d in dims)
                # a record variable's first dimension is the unlimited one,
                # whose length in the header is 0
                is_rec = bool(dims) and self.dimensions[dims[0]] == 0
                self.variables[nm] = Variable(nm, dims, shape, _TYPEMAP[tp],
                                              vsize, begin, is_rec)

    def __contains__(self, name):
        return name in self.variables

    def __getitem__(self, name) -> np.ndarray:
        v = self.variables[name]
        if not v.is_record:
            count = int(np.prod(v.shape)) if v.shape else 1
            out = np.frombuffer(self._data, v.dtype, count=count,
                                offset=v.begin).reshape(v.shape)
        else:
            # records interleave the record variables: the stride is the
            # sum of their vsizes, except that a lone record variable is
            # stored contiguously (the format's special case)
            rec_vars = [w for w in self.variables.values() if w.is_record]
            stride = v.vsize if len(rec_vars) == 1 \
                else sum(w.vsize for w in rec_vars)
            inner = v.shape[1:]
            per = int(np.prod(inner)) if inner else 1
            recs = [np.frombuffer(self._data, v.dtype, count=per,
                                  offset=v.begin + rec * stride)
                    for rec in range(self.numrecs)]
            out = np.stack(recs).reshape((self.numrecs,) + inner) if recs \
                else np.zeros((0,) + inner, v.dtype)
        return out.astype(out.dtype.newbyteorder("="))
