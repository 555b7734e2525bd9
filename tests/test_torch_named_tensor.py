"""The port's NamedArray against the JAX package's: the cases of
tests/test_named_tensor.py and the rest of its public API (spatial dims,
replace, astype, select_array, index_select, slice_dim, unsqueeze,
squeeze, select_features, stack, new_like), on numpy arrays and on torch
tensors, from the same numpy inputs; and Item.unsqueeze / Item.squeeze
against the JAX package's Item. Every result must be equal: names,
feature names, dtype kind and values."""

import datetime as dt

import numpy as np
import pytest
import torch

from py4cast_tpu.datasets.base import Item as JaxItem
from py4cast_tpu.named_tensor import NON_SPATIAL as JAX_NON_SPATIAL
from py4cast_tpu.named_tensor import NamedArray as JaxNamedArray
from py4cast_tpu_torch.datasets.base import Item
from py4cast_tpu_torch.named_tensor import NON_SPATIAL, NamedArray

NAMES = ("timestep", "lat", "lon", "features")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as every port test file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["numpy", "torch"])
def wrap(request):
    """How the port's arrays are held: numpy, or a torch tensor."""
    return (lambda a: a) if request.param == "numpy" else torch.from_numpy


def _host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want):
    """A port NamedArray (or raw array) equal to a JAX one."""
    if isinstance(want, JaxNamedArray):
        assert got.names == want.names
        assert got.feature_names == want.feature_names
        got, want = got.array, want.array
    np.testing.assert_array_equal(_host(got), np.asarray(want))


def _pair(wrap, shape=(2, 4, 4, 3), features=("u", "v", "t"), names=NAMES, seed=0):
    """The same numpy data as a port and a JAX NamedArray."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return NamedArray(wrap(a.copy()), names, features), JaxNamedArray(a, names, features)


def test_non_spatial_members_match():
    assert NON_SPATIAL == JAX_NON_SPATIAL


def test_metadata_and_spatial_dims(wrap):
    nt, jt = _pair(wrap)
    assert nt.dim_index("lat") == jt.dim_index("lat") == 1
    assert nt.dim_size("timestep") == jt.dim_size("timestep") == 2
    assert nt.feature_index("v") == jt.feature_index("v") == 1
    assert nt.spatial_dim_idx == jt.spatial_dim_idx == [1, 2]
    assert nt.spatial_dim_names == jt.spatial_dim_names == ["lat", "lon"]
    assert nt.num_spatial_dims == jt.num_spatial_dims == 2
    members, jmembers = _pair(wrap, (3, 2, 5, 1), ("u",), ("members", "timestep", "ngrid",
                                                              "features"))
    assert members.spatial_dim_names == jmembers.spatial_dim_names == ["ngrid"]


@pytest.mark.parametrize("array,names,features", [
    (np.zeros((2, 4, 4, 3)), NAMES, ("u", "v")),  # feature count
    (np.zeros((2, 4)), ("a", "b", "c"), ()),  # rank
])
def test_mismatches_raise(wrap, array, names, features):
    with pytest.raises(ValueError):
        JaxNamedArray(array, names, features)
    with pytest.raises(ValueError):
        NamedArray(wrap(array), names, features)


def test_select_and_select_array(wrap):
    nt, jt = _pair(wrap)
    _same(nt.select("timestep", 1), jt.select("timestep", 1))
    _same(nt.select_array("lon", 2), jt.select_array("lon", 2))


def test_index_select_and_slice_dim_keep_the_dim(wrap):
    nt, jt = _pair(wrap)
    _same(nt.index_select("timestep", [1]), jt.index_select("timestep", [1]))
    _same(nt.index_select("lat", [3, 0, 3]), jt.index_select("lat", [3, 0, 3]))
    _same(nt.slice_dim("lon", 1, 3), jt.slice_dim("lon", 1, 3))


def test_flatten_unflatten_roundtrip(wrap):
    nt, jt = _pair(wrap)
    flat, jflat = nt.flatten("ngrid", 1, 2), jt.flatten("ngrid", 1, 2)
    _same(flat, jflat)
    _same(flat.unflatten("ngrid", (4, 4), ("lat", "lon")),
          jflat.unflatten("ngrid", (4, 4), ("lat", "lon")))


def test_concat_features(wrap):
    a, ja = _pair(wrap)
    b, jb = _pair(wrap, (2, 4, 4, 1), ("q",), seed=1)
    _same(NamedArray.concat([a, b]), JaxNamedArray.concat([ja, jb]))
    _same(a | b, ja | jb)
    other, _ = _pair(wrap, (2, 4, 4, 1), ("q",), ("batch", "lat", "lon", "features"))
    with pytest.raises(ValueError):
        NamedArray.concat([a, other])
    with pytest.raises(ValueError):
        NamedArray.concat([a, a])


def test_getitem_and_select_features(wrap):
    nt, jt = _pair(wrap)
    _same(nt["v"], jt["v"])
    _same(nt.select_features(["t", "u"]), jt.select_features(["t", "u"]))


def test_unsqueeze_squeeze(wrap):
    nt, jt = _pair(wrap)
    b, jb = nt.unsqueeze("batch", 0), jt.unsqueeze("batch", 0)
    _same(b, jb)
    _same(nt.unsqueeze("members", 2), jt.unsqueeze("members", 2))
    _same(b.squeeze("batch"), jb.squeeze("batch"))
    both = b.unsqueeze("members", 1)
    _same(both.squeeze(["members", "batch"]),
          jb.unsqueeze("members", 1).squeeze(["members", "batch"]))
    with pytest.raises(ValueError, match="cannot squeeze"):
        b.squeeze("timestep")  # size 2


def test_broadcast_like(wrap):
    target, jtarget = _pair(wrap)
    cal, jcal = _pair(wrap, (2, 2), ("a", "b"), ("timestep", "features"), seed=2)
    _same(cal.broadcast_like(target), jcal.broadcast_like(jtarget))


def test_replace_astype_new_like_stack(wrap):
    nt, jt = _pair(wrap)
    _same(nt.replace(nt.array * 2), jt.replace(jt.array * 2))
    if isinstance(nt.array, torch.Tensor):
        wide = nt.astype(torch.float64)
        assert wide.array.dtype == torch.float64
    else:
        wide = nt.astype(np.float64)
        assert wide.array.dtype == np.float64
    _same(wide, jt.astype(np.float64))
    _same(NamedArray.new_like(nt.array + 1, nt), JaxNamedArray.new_like(jt.array + 1, jt))
    m, jm = _pair(wrap, seed=3)
    _same(NamedArray.stack([nt, m], "members", 1), JaxNamedArray.stack([jt, jm], "members", 1))


def _items(wrap):
    """The same sample as a port Item and a JAX Item."""
    times = [dt.datetime(2023, 1, 1, h) for h in range(2)]
    (i, ji), (o, jo) = (_pair(wrap, seed=s) for s in range(2))
    f, jf = _pair(wrap, (2, 4, 4, 2), ("cos_hour", "sin_hour"), seed=4)
    return (Item(inputs=i, forcing=f, outputs=o, validity_times=times),
            JaxItem(inputs=ji, forcing=jf, outputs=jo, validity_times=times))


def test_item_unsqueeze_squeeze(wrap):
    item, jitem = _items(wrap)
    got, want = item.unsqueeze("batch", 0), jitem.unsqueeze("batch", 0)
    for name in ("inputs", "forcing", "outputs"):
        _same(getattr(got, name), getattr(want, name))
    back, jback = got.squeeze("batch"), want.squeeze("batch")
    for name in ("inputs", "forcing", "outputs"):
        _same(getattr(back, name), getattr(jback, name))
    assert back.validity_times == item.validity_times
    no_inputs = Item(inputs=None, forcing=None, outputs=item.outputs,
                     validity_times=item.validity_times).unsqueeze("batch", 0)
    assert no_inputs.inputs is None and no_inputs.forcing is None
    assert no_inputs.outputs.names == ("batch",) + NAMES
