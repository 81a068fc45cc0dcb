"""The port's HDF5 reader and writer (``data/hdf5.py``) held against h5py, in both directions.

h5py (the HDF5 library) is the independent yardstick: it writes files in its
two layouts, ``libver="earliest"`` (superblock 0, version-1 object headers,
symbol-table groups under a v1 B-tree) and ``libver="latest"`` (superblock
3, ``OHDR`` headers, link messages), with and without a 512-byte user block,
and the port's reader must return every array and attribute bit for bit. The
port's files must read in h5py to the same arrays, dtypes, shapes and
attributes, the dimension scales attached. Unsupported features raise an
error that names the file. CPU only, a few seconds.
"""

import struct

import numpy as np
import pytest

from climateparameterizations_jl_tpu_torch.data import hdf5

h5py = pytest.importorskip("h5py")

N_EARLIEST = 600  # the group of many links: several B-tree levels in the earliest layout
N_LATEST = 8  # the most links h5py keeps in the header before it goes dense


def _compact(group, name, data):
    """A dataset with the compact layout (the data inside its object header)."""
    space = h5py.h5s.create_simple(data.shape) if data.shape else h5py.h5s.create(h5py.h5s.SCALAR)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    dsid = h5py.h5d.create(group.id, name.encode(), h5py.h5t.py_create(data.dtype), space, dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


def _h5py_tree(path, libver, userblock):
    rng = np.random.default_rng(7)
    with h5py.File(path, "w", libver=libver, userblock_size=userblock) as f:
        g = f.create_group("timeseries/T")
        for i in range(N_EARLIEST if libver == "earliest" else N_LATEST):
            g[str(i * 600)] = rng.normal(size=(12, 1, 1))
        f["grid/Lz"] = 256.0
        f["grid/Hz"] = np.int32(3)
        f["grid/Nz"] = np.int64(32)
        f["grid/zC"] = rng.normal(size=38)
        f["buoyancy/model/equation_of_state/α"] = np.float32(2e-4)
        f["buoyancy/model/equation_of_state/β"] = 0.0
        f["serialized/location"] = np.bytes_(b"(Center, Center, Face)")
        data = f.create_group("data")  # no group holds more than 8 links: the latest layout keeps them compact
        _compact(data, "compact_f4", rng.normal(size=5).astype(np.float32))
        _compact(data, "compact_i8", np.arange(-3, 4, dtype=np.int64))
        _compact(data, "compact_scalar", np.array(1.5))
        data["i4"] = np.arange(-4, 5, dtype=np.int32)
        data["empty"] = np.zeros(0)
        f.attrs["title"] = "θ profiles"  # variable length, UTF-8
        f.attrs["fixed"] = np.bytes_(b"fixed-length")
        f.attrs["names"] = np.array([b"time", b"zC"])
        f.attrs["dt"] = 600.0
        f.attrs["n"] = np.int32(9)
        f.attrs["vector"] = rng.normal(size=4).astype(np.float32)
        ds = f["grid/zC"]
        for k in range(6):  # added after the header was written: continuation blocks (OCHK in the latest layout)
            ds.attrs[f"note_{k}"] = "x" * 120 + str(k)
        nc = f.create_group("nc")
        time = nc.create_dataset("time", data=np.arange(3.0))
        time.make_scale("time")
        zc = nc.create_dataset("zc", data=np.linspace(-1.0, 0.0, 4))
        zc.make_scale("zc")
        var = nc.create_dataset("T", data=rng.normal(size=(3, 4)).astype(np.float32))
        var.dims[0].attach_scale(time)
        var.dims[1].attach_scale(zc)


def _same(got, want, what):
    if isinstance(want, str):
        assert got == want, what
        return
    if isinstance(want, np.ndarray) and want.dtype.names:  # REFERENCE_LIST: compare the dimension indices
        assert [g[1] for g in got] == list(want["dimension"]), what
        return
    if isinstance(want, np.ndarray) and want.dtype == object:  # DIMENSION_LIST: one reference per axis here
        assert len(got) == len(want) and all(len(g) == len(w) for g, w in zip(got, want)), what
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _compare_with_h5py(path):
    """Every dataset and attribute the port reads equals h5py's, bit for bit; returns the count."""
    seen = 0
    with h5py.File(path, "r") as ref, hdf5.File(path, "r") as ours:
        def visit(name, obj):
            nonlocal seen
            node = ours[name]
            if isinstance(obj, h5py.Dataset):
                assert isinstance(node, hdf5.Dataset), name
                assert node.shape == obj.shape and node.dtype == obj.dtype, name
                _same(node[()], obj[()], name)
            else:
                assert isinstance(node, hdf5.Group) and sorted(node.keys()) == sorted(obj.keys()), name
            assert sorted(node.attrs) == sorted(obj.attrs), name
            for key, value in obj.attrs.items():
                _same(node.attrs[key], value, f"{name}@{key}")
            seen += 1

        ref.visititems(visit)
        assert sorted(ours.attrs) == sorted(ref.attrs)
        for key, value in ref.attrs.items():
            _same(ours.attrs[key], value, f"/@{key}")
    return seen


@pytest.mark.parametrize("userblock", [0, 512])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reader_matches_h5py(tmp_path, libver, userblock):
    path = str(tmp_path / f"{libver}_{userblock}.jld2")
    _h5py_tree(path, libver, userblock)
    with open(path, "rb") as fh:
        head = fh.read(userblock + 9)
    assert head[userblock:userblock + 8] == hdf5.SIGNATURE
    assert head[-1] == (0 if libver == "earliest" else 3)  # the superblock version each layout has
    n = _compare_with_h5py(path)
    assert n > (N_EARLIEST if libver == "earliest" else N_LATEST)
    with hdf5.File(path, "r") as f:
        assert [d[0].name for d in f["nc/T"].dims] == ["/nc/time", "/nc/zc"]
        assert f["serialized/location"][()] == b"(Center, Center, Face)"
        assert f.attrs["title"] == "θ profiles"
        assert "buoyancy/model/equation_of_state/α" in f and "grid/nothing" not in f and "grid/Lz/x" not in f


def _btree_level(path, group):
    """The level of the root node of a symbol-table group's v1 B-tree (0: one leaf)."""
    with hdf5.File(path, "r") as f:
        r = f._r
        stab = next(d for t, _, d in r.messages(f[group]._address) if t == hdf5.MSG_SYMBOL_TABLE)
        return r.buf[r.at(struct.unpack_from("<Q", stab)[0]) + 5]


def test_earliest_layout_has_a_multilevel_btree(tmp_path):
    path = str(tmp_path / "earliest.h5")
    _h5py_tree(path, "earliest", 0)
    assert _btree_level(path, "timeseries/T") >= 1
    with hdf5.File(path, "r") as f:
        keys = f["timeseries/T"].keys()
    assert sorted(keys, key=int) == [str(600 * i) for i in range(N_EARLIEST)]


def _port_tree(path, n_links):
    rng = np.random.default_rng(11)
    want = {}
    with hdf5.File(path, "w") as f:
        g = f.create_group("timeseries/T")
        for i in range(n_links):
            want[f"timeseries/T/{i}"] = g[str(i)] = rng.normal(size=(9, 1, 1))
        for name, value in {"grid/Lz": np.float64(256.0), "grid/Nz": np.int64(32), "grid/Hz": np.int32(3),
                            "buoyancy/model/equation_of_state/α": np.float64(2e-4), "u8": np.arange(5, dtype=np.uint8),
                            "f4": rng.normal(size=(2, 3)).astype(np.float32), "empty": np.zeros(0),
                            "serialized/location": np.bytes_(b"(Center, Center, Center)")}.items():
            f[name] = value
            want[name] = value
        f.attrs["_NCProperties"] = np.bytes_(b"version=2")
        f.attrs["simulation"] = "free_convection_3"
        f.attrs["dt"] = 600.0
        f.attrs["simulation_id"] = 8
        time = f.create_dataset("time", data=np.arange(3.0))
        time.make_scale("time")
        zc = f.create_dataset("zC", data=np.linspace(-1.0, 0.0, 4))
        zc.make_scale("zC")
        for name, dt in (("T", np.float64), ("wT", np.float32)):
            var = f.create_dataset(name, data=rng.normal(size=(3, 4)).astype(dt))
            var.attrs["_dims"] = np.array([b"time", b"zC"])
            var.dims[0].attach_scale(time)
            var.dims[1].attach_scale(zc)
            want[name] = var.data
    return want


@pytest.mark.parametrize("n_links", [3, N_EARLIEST])
def test_writer_is_read_by_h5py(tmp_path, n_links):
    path = str(tmp_path / "port.h5")
    want = _port_tree(path, n_links)
    with h5py.File(path, "r") as f:
        for name, value in want.items():
            got = f[name][()]
            _same(got, value, name)
        assert dict(f.attrs) == {"_NCProperties": b"version=2", "simulation": "free_convection_3", "dt": 600.0,
                                 "simulation_id": 8}
        assert isinstance(f.attrs["simulation"], str) and f.attrs["simulation_id"].dtype == np.int64
        for var in ("T", "wT"):
            assert [f[var].dims[i][0].name for i in range(2)] == ["/time", "/zC"]
            assert list(f[var].attrs["_dims"]) == [b"time", b"zC"]
        assert f["zC"].is_scale and f["zC"].attrs["CLASS"] == b"DIMENSION_SCALE" and f["zC"].attrs["NAME"] == b"zC"
        assert sorted(r[1] for r in f["zC"].attrs["REFERENCE_LIST"]) == [1, 1]
        assert [f[r[0]].name for r in f["time"].attrs["REFERENCE_LIST"]] == ["/T", "/wT"]
    assert _compare_with_h5py(path) == len(want) + 9  # 7 groups and 2 scales more; the port reads it as h5py


def test_writer_copies_the_data(tmp_path):
    path = str(tmp_path / "copy.h5")
    a = np.arange(4.0)
    with hdf5.File(path, "w") as f:
        f["a"] = a
        a[:] = -1.0
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["a"][()], np.arange(4.0))


def test_lookup3_known_values():
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551  # lookup3.c's driver5
    assert hdf5.lookup3(b"Four score and seven years ago", 1) == 0xCD628161


def _unsupported(f, case):
    """Write, with h5py, one feature the port's reader refuses, at ``g`` or ``g/x``."""
    if case == "dense_links":
        for i in range(N_LATEST + 1):
            f[f"g/{i}"] = float(i)
    elif case == "chunked":
        f.create_dataset("g/x", data=np.arange(8.0), chunks=(4,))
    elif case == "gzip":
        f.create_dataset("g/x", data=np.arange(8.0), compression="gzip")
    elif case == "big_endian":
        f["g/x"] = np.arange(8.0, dtype=">f8")
    elif case == "dense_attributes":
        f["g/x"] = 1.0
        for i in range(N_LATEST + 12):
            f["g/x"].attrs[f"a{i}"] = i
    elif case == "soft_link":
        f["x"] = 1.0
        f.create_group("g")["x"] = h5py.SoftLink("/x")


@pytest.mark.parametrize("case,feature", [
    ("dense_links", "dense link storage"),
    ("chunked", "chunked"),
    ("gzip", "filter pipeline"),
    ("big_endian", "big-endian"),
    ("dense_attributes", "dense attribute storage"),
    ("soft_link", "soft link"),
])
def test_unsupported_features_raise_naming_the_file(tmp_path, case, feature):
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", libver="latest") as f:
        _unsupported(f, case)
    with pytest.raises(hdf5.HDF5Error, match=feature) as err, hdf5.File(path, "r") as f:
        node = f["g"]
        list(node.keys())
        x = f["g/x"]
        x.attrs, x[()]  # noqa: B018
    assert path in str(err.value)


def test_corruption_and_foreign_files_raise(tmp_path):
    path = str(tmp_path / "port.h5")
    _port_tree(path, 3)
    raw = bytearray(open(path, "rb").read())
    at = raw.index(b"OHDR", 64)
    raw[at + 12] ^= 0xFF
    bad = tmp_path / "bad.h5"
    bad.write_bytes(bytes(raw))
    with pytest.raises(hdf5.HDF5Error, match="checksum") as err, hdf5.File(str(bad), "r") as f:
        for name in ["timeseries", "grid", "buoyancy", "u8", "f4", "T", "wT", "time", "zC", "empty"]:
            f[name].attrs  # noqa: B018
    assert str(bad) in str(err.value)
    (tmp_path / "text.txt").write_bytes(b"not hdf5" * 200)
    with pytest.raises(hdf5.HDF5Error, match="no HDF5 superblock"):
        hdf5.File(str(tmp_path / "text.txt"), "r")
    with pytest.raises(hdf5.HDF5Error, match="dtype"):
        with hdf5.File(str(tmp_path / "c.h5"), "w") as f:
            f["z"] = np.ones(2, np.complex64)
