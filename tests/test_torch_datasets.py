"""The port's Titan, Poesy and Rainfall accessors, statistics and dataset
CLI against the JAX package's, on the CPU, on one synthetic tree in each
dataset's layout (the generators and shapes of tests/test_accessors.py)
that both packages read: the sample lists (timestamps and members) and
the items bit for bit, standardized and raw; the fused batch read
against the per-param read; weights per level, grid geometry, Poesy's
lead-time pruning and Rainfall's units; the statistics, each package
reading the other's JSON; ``fit_to_grid`` within 1e-5 of the JAX
function; the grib and zarr paths' ImportErrors.

The trees live under this module's own temporary directory; both
packages' path attributes point there for the module's tests only."""

import datetime as dt
import json
import warnings

import numpy as np
import pytest
import torch

import py4cast_tpu.datasets.poesy as jax_poesy
import py4cast_tpu.datasets.rainfall as jax_rainfall
import py4cast_tpu.datasets.titan as jax_titan
import py4cast_tpu_torch.datasets.poesy as port_poesy
import py4cast_tpu_torch.datasets.rainfall as port_rainfall
import py4cast_tpu_torch.datasets.titan as port_titan
from py4cast_tpu.datasets import compute_stats as jax_stats
from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.datasets.access import Grid as JaxGrid
from py4cast_tpu.datasets.access import Stats as JaxStats
from py4cast_tpu.datasets.access import WeatherParam as JaxWeatherParam
from py4cast_tpu_torch.datasets import compute_stats as port_stats
from py4cast_tpu_torch.datasets import dataset_cli
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.datasets.access import Grid, Stats, WeatherParam
from py4cast_tpu_torch.datasets.synthetic_trees import (
    write_poesy_tree,
    write_rainfall_tree,
    write_titan_tree,
)

TITAN_CONF = {
    "periods": {
        "train": {"start": 20230101, "end": 20230101, "obs_step": 3600},
        "valid": {"start": 20230102, "end": 20230102, "obs_step": 3600},
        "test": {"start": 20230102, "end": 20230102, "obs_step": 3600},
    },
    "grid": {"name": "PAAROME_1S40", "border_size": 2, "subdomain": [100, 132, 240, 272]},
    "settings": {"standardize": True, "file_format": "npy"},
    "params": {
        "aro_t2m": {"levels": [2], "kind": "input_output"},
        "arp_t": {"levels": [500], "kind": "input"},
    },
}
TITAN_DATES = [dt.datetime(2023, 1, 1) + dt.timedelta(hours=h) for h in range(40)] + [
    dt.datetime(2023, 1, 2) + dt.timedelta(hours=h) for h in range(40)]

POESY_PERIOD = {"refcst_daily_runs": [0], "refcst_leadtime_start_in_sec": 3600,
                "refcst_leadtime_end_in_sec": 21600, "refcst_leadtime_step_in_sec": 3600,
                "start": 20210601, "end": 20210601}
POESY_CONF = {
    "periods": {
        "train": {**POESY_PERIOD, "refcst_daily_runs": [0, 43200],
                  "refcst_leadtime_end_in_sec": 43200},
        "valid": POESY_PERIOD,
        "test": POESY_PERIOD,
    },
    "grid": {"name": "EURW1S40", "border_size": 2},
    "settings": {"standardize": False, "file_format": "npy"},
    "members": [0, 3],
    "params": {
        "t2m": {"levels": [2], "kind": "input_output"},
        "u10": {"levels": [10], "kind": "input_output"},
    },
}

RAINFALL_PERIOD = {"start": 20230601, "end": 20230601, "obs_step": 300}
RAINFALL_CONF = {
    "periods": {"train": RAINFALL_PERIOD, "valid": RAINFALL_PERIOD, "test": RAINFALL_PERIOD},
    "grid": {"name": "rain", "border_size": 2, "subdomain": [0, 64, 0, 64]},
    "settings": {"standardize": False, "file_format": "npz"},
    "params": {"precip": {"levels": [0], "kind": "input_output"}},
}

#: (name, conf, input steps): each dataset as both packages build it
CASES = {
    "titan_aro_arp": (TITAN_CONF, 2),
    "poesy": (POESY_CONF, 2),
    "rainfall": (RAINFALL_CONF, 2),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree a dataset, both packages pointed at it."""
    root = tmp_path_factory.mktemp("trees")
    write_titan_tree(root / "titan", "titan_aro_arp_PAAROME_1S40_100-132-240-272",
                     {"aro_t2m_2m": (5.0, 285.0), "arp_t_500hpa": (5.0, 260.0)},
                     TITAN_DATES, (32, 32), seed=0)
    write_poesy_tree(root / "poesy", (24, 24, 45, 16),
                     [dt.datetime(2021, 6, 1), dt.datetime(2021, 6, 1, 12)],
                     variables=("t2m", "u10", "v10"), seed=1, slab_rows=7)
    write_rainfall_tree(root / "rainfall", dt.datetime(2023, 6, 1), 12, (64, 64), seed=2)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_titan, port_titan):
            mp.setattr(mod, "TITAN_PATH", root / "titan")
        for mod in (jax_poesy, port_poesy):
            mp.setattr(mod, "POESY_PATH", root / "poesy")
            mp.setattr(mod, "CACHE_DIR", root / "cache")
        for mod in (jax_rainfall, port_rainfall):
            mp.setattr(mod, "RAINFALL_PATH", root / "rainfall")
        yield root


def _build(get_datasets, name, standardize):
    conf, n_in = CASES[name]
    conf = {**conf, "settings": {**conf["settings"], "standardize": standardize}}
    return get_datasets(name, n_in, 1, 2, dataset_conf=conf)


@pytest.fixture(scope="module")
def stats(trees):
    """Both statistics files of every dataset, computed by the JAX
    package (the port's are compared with them below)."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in CASES:
            train = _build(jax_get_datasets, name, False)[0]
            params = jax_stats.compute_parameters_stats(train)
            train = _build(jax_get_datasets, name, True)[0]
            diffs = jax_stats.compute_time_step_stats(train)
            out[name] = (params.stats, diffs.stats, train.cache_dir)
    return out


def _samples(ds):
    return [(s.timestamps.datetime, list(s.timestamps.timedeltas), s.member)
            for s in ds.sample_list]


@pytest.mark.parametrize("name", list(CASES))
def test_sample_lists_equal(trees, stats, name):
    for want, got in zip(_build(jax_get_datasets, name, True),
                         _build(port_get_datasets, name, True)):
        assert _samples(got) == _samples(want) and len(got) > 0
        assert got.cache_dir == want.cache_dir
    if name == "poesy":
        assert {s.member for s in got.sample_list} == {0, 3}


def _assert_items_equal(got, want):
    for attr in ("inputs", "outputs", "forcing"):
        w, g = getattr(want, attr), getattr(got, attr)
        assert g.names == w.names and g.feature_names == w.feature_names
        assert g.array.dtype == np.float32
        np.testing.assert_array_equal(g.array, np.asarray(w.array))
    assert got.validity_times == want.validity_times


@pytest.mark.parametrize("standardize", [True, False], ids=["standardized", "raw"])
@pytest.mark.parametrize("name", list(CASES))
def test_items_equal_bit_for_bit(trees, stats, name, standardize):
    jax_ds = _build(jax_get_datasets, name, standardize)[0]
    port_ds = _build(port_get_datasets, name, standardize)[0]
    for i in sorted({0, len(port_ds) // 2, len(port_ds) - 1}):
        _assert_items_equal(port_ds[i], jax_ds[i])


def test_dataset_info_equal(trees, stats):
    for name in CASES:
        want = _build(jax_get_datasets, name, True)[0].dataset_info
        got = _build(port_get_datasets, name, True)[0].dataset_info
        for attr in ("name", "weather_dim", "forcing_dim", "pred_step", "state_weights",
                     "output_feature_names", "forcing_feature_names", "units", "shortnames"):
            assert getattr(got, attr) == getattr(want, attr), (name, attr)
        np.testing.assert_array_equal(got.statics.grid_statics.array,
                                      want.statics.grid_statics.array)
        assert got.stats.stats == want.stats.stats


@pytest.mark.parametrize("standardize", [True, False], ids=["standardized", "raw"])
def test_fused_read_equals_per_param_read(trees, stats, standardize):
    """Titan's whole-sample fused read against each param's own read,
    bit for bit; Poesy (a memory map) and Rainfall (converted on load)
    name no files, so the fused read never takes them."""
    ds = _build(port_get_datasets, "titan_aro_arp", standardize)[0]
    for sample in (ds.sample_list[0], ds.sample_list[-1]):
        fused = sample._batched_param_arrays(standardize)
        assert fused is not None
        for p in sample.params:
            want = sample.get_param_array(p, sample._param_stamps(p), standardize)
            np.testing.assert_array_equal(fused[sample.accessor.parameter_namer(p)], want)
    for name in ("poesy", "rainfall"):
        sample = _build(port_get_datasets, name, False)[0].sample_list[0]
        assert sample._batched_param_arrays(False) is None


def test_loader_with_many_workers_is_whole(trees, stats):
    """Four prefetching workers, each reading through the C++ reader's
    own pool: every batch equals its items, in order."""
    ds = _build(port_get_datasets, "titan_aro_arp", True)[0]
    batches = list(ds.loader(batch_size=3, num_workers=4, prefetch=4, drop_last=False,
                             pad_last=True))
    assert len(batches) == -(-len(ds) // 3)
    for b, batch in enumerate(batches):
        for r in range(batch.valid_count):
            item = ds[3 * b + r]
            for attr in ("inputs", "outputs", "forcing"):
                np.testing.assert_array_equal(getattr(batch, attr).array[r],
                                              getattr(item, attr).array)


def test_weights_geometry_pruning_and_units(trees):
    for level, kind in [(500, "isobaricInhPa"), (850, "isobaricInhPa"), (2, "heightAboveGround"),
                        (0, "surface")]:
        assert (port_titan.TitanAccessor.get_weight_per_level(level, kind)
                == jax_titan.TitanAccessor.get_weight_per_level(level, kind))
    for level, kind in [(2, "heightAboveGround"), (0, "surface"), (500, "isobaricInHpa")]:
        assert (port_poesy.PoesyAccessor.get_weight_per_level(level, kind)
                == jax_poesy.PoesyAccessor.get_weight_per_level(level, kind))
    assert port_rainfall.RainfallAccessor.get_weight_per_level(0, "surface") == 1.0

    pairs = [(port_titan.TitanAccessor, jax_titan.TitanAccessor, "PAAROME_1S40"),
             (port_titan.TitanAccessor, jax_titan.TitanAccessor, "PAAROME_1S100"),
             (port_poesy.PoesyAccessor, jax_poesy.PoesyAccessor, "EURW1S40"),
             (port_rainfall.RainfallAccessor, jax_rainfall.RainfallAccessor, "rain")]
    for port_kls, jax_kls, grid in pairs:
        got, want = port_kls.load_grid_info(grid), jax_kls.load_grid_info(grid)
        assert tuple(got.full_size) == tuple(want.full_size)
        for attr in ("latitude", "longitude", "geopotential", "landsea_mask"):
            if getattr(want, attr) is None:
                assert getattr(got, attr) is None
            else:
                np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert port_titan.TitanAccessor.load_grid_info("PAAROME_1S40").full_size == (717, 1121)
    assert (port_rainfall.domain_to_extent(port_rainfall.DOMAIN)
            == jax_rainfall.domain_to_extent(jax_rainfall.DOMAIN))

    t0, hour = dt.datetime(2021, 6, 1), dt.timedelta(hours=1)
    for n_in, n_pred in [(1, 1), (2, 1), (2, 3)]:
        for h in range(0, 48):
            args = (t0, n_in, n_pred, hour, dt.timedelta(hours=h))
            assert (port_poesy.PoesyAccessor.optional_check_before_exists(*args)
                    == jax_poesy.PoesyAccessor.optional_check_before_exists(*args))
    assert port_poesy.PoesyAccessor.optional_check_before_exists(t0, 1, 1, hour, 10 * hour)
    assert not port_poesy.PoesyAccessor.optional_check_before_exists(t0, 1, 1, hour, 45 * hour)

    ds = _build(port_get_datasets, "rainfall", False)[0]
    raw = np.load(port_rainfall.RainfallAccessor._date_filepath(
        ds.sample_list[0].timestamps.validity_times[0]))["arr_0"]
    item = ds[0]
    want = np.where(raw < 0, 0, raw)[::-1] / 100.0 * 12.0  # mm/100 a 5 min -> mm/h, flipped
    np.testing.assert_array_equal(item.inputs.array[0, ..., 0], want.astype(np.float32))
    assert item.outputs.array.min() >= 0.0 and item.outputs.array.max() <= 500 / 100 * 12


@pytest.mark.parametrize("name", list(CASES))
def test_statistics_agree_and_each_package_reads_the_others(trees, stats, name):
    """The port's statistics equal the JAX package's; the JSON the port
    writes loads in the JAX package and the JAX package's in the port,
    and both standardize an item to the same bits."""
    want_params, want_diffs, cache = stats[name]
    jax_json = {f: json.loads((cache / f).read_text())
                for f in ("parameters_stats.json", "diff_stats.json")}
    train = _build(port_get_datasets, name, False)[0]
    got_params = port_stats.compute_parameters_stats(train)
    train = _build(port_get_datasets, name, True)[0]
    got_diffs = port_stats.compute_time_step_stats(train)
    assert got_params.stats == want_params
    assert got_diffs.stats == want_diffs
    # the files now on disk are the port's: the JAX package reads them
    for f, want in jax_json.items():
        assert JaxStats(fname=cache / f).stats == json.loads((cache / f).read_text()) == want
        assert Stats(fname=cache / f).stats == want
    _assert_items_equal(_build(port_get_datasets, name, True)[0][0],
                        _build(jax_get_datasets, name, True)[0][0])


def _arp_param(grid_kls, param_kls, accessor, grid_name):
    grid = grid_kls(load_grid_info_func=accessor.load_grid_info, name=grid_name)
    return param_kls(name="arp_t", level=500, grid=grid, kind="input",
                     load_param_info=accessor.load_param_info,
                     get_weight_per_level=accessor.get_weight_per_level)


@pytest.mark.parametrize("grid_name", ["PAAROME_1S40", "PAAROME_1S100"])
def test_fit_to_grid_matches_jax(grid_name):
    """ARPEGE's PA_01D field, cropped to AROME's box and grown to the
    grid, on random fields with PA_01D's real lon/lat axes: within 1e-5
    of the JAX function (jax.image.resize, antialiased toward 1S40)."""
    from py4cast_tpu.datasets.titan.metadata import GRIDS

    g = GRIDS["PA_01D"]
    lats = np.linspace(g["extent"][0], g["extent"][1], g["size"][0])
    lons = np.linspace(g["extent"][2], g["extent"][3], g["size"][1])
    arr = (np.random.default_rng(3).standard_normal(g["size"]) * 5 + 260).astype(np.float32)
    port_param = _arp_param(Grid, WeatherParam, port_titan.TitanAccessor, grid_name)
    jax_param = _arp_param(JaxGrid, JaxWeatherParam, jax_titan.TitanAccessor, grid_name)
    assert port_param.native_grid == "PA_01D"
    got = port_titan.fit_to_grid(port_param, arr, lons, lats,
                                 port_titan.TitanAccessor.get_grid_coords)
    want = np.asarray(jax_titan.fit_to_grid(jax_param, arr, lons, lats,
                                            jax_titan.TitanAccessor.get_grid_coords))
    assert got.shape == want.shape == tuple(GRIDS[grid_name]["size"])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 260)
    # growing, the antialias changes nothing in torch either
    coords = port_titan.TitanAccessor.get_grid_coords(port_param)
    in_lat = (lats >= coords[1]) & (lats <= coords[0])
    crop = arr[in_lat][:, (lons >= coords[2]) & (lons <= coords[3])]
    x = torch.from_numpy(np.ascontiguousarray(crop))[None, None]
    grown = {aa: torch.nn.functional.interpolate(x, size=got.shape, mode="bilinear",
                                                 align_corners=False, antialias=aa)[0, 0]
             for aa in (True, False)}
    torch.testing.assert_close(grown[True], grown[False], rtol=1e-6, atol=1e-6 * 260)
    np.testing.assert_array_equal(got, grown[port_param.grid.name == "PAAROME_1S40"].numpy())


def test_grib_and_zarr_paths_name_the_missing_package(trees, tmp_path):
    port_titan.read_grib.cache_clear()
    with pytest.raises(ImportError, match="xarray and cfgrib"):
        port_titan.read_grib(tmp_path / "x.grib")
    ds = _build(port_get_datasets, "titan_aro_arp", False)[0]
    p, date = ds.params[0], ds.sample_list[0].timestamps.validity_times[0]
    with pytest.raises(ImportError, match="xarray and cfgrib"):
        port_titan.TitanAccessor.load_data_for_date(ds.name, p, date, file_format="grib")
    with pytest.raises(ImportError, match="xarray and cfgrib"):
        dataset_cli.convert_samples_grib2_numpy(ds)
    from py4cast_tpu_torch.datasets.titan import npy2zarr

    with pytest.raises(ImportError, match="zarr"):
        npy2zarr.convert(trees / "titan", tmp_path / "out.zarr")


def test_dataset_cli_commands(trees, stats, tmp_path, capsys):
    """prepare (statistics), describe, plot and speedtest through the
    port's dataset CLI on the Titan tree; the conf file's stem names the
    dataset, as in the JAX package."""
    conf = tmp_path / "titan_aro_arp.json"
    conf.write_text(json.dumps(TITAN_CONF))
    common = ["--dataset-conf", str(conf), "--num-input-steps", "2", "--batch-size", "2"]
    cache = _build(port_get_datasets, "titan_aro_arp", True)[0].cache_dir
    (cache / "parameters_stats.json").unlink()
    (cache / "diff_stats.json").unlink()
    assert dataset_cli.main(["titan_aro_arp", "prepare", *common]) == 0
    assert (cache / "parameters_stats.json").is_file() and (cache / "diff_stats.json").is_file()
    assert dataset_cli.main(["titan_aro_arp", "describe", *common]) == 0
    out = capsys.readouterr().out
    assert "Summarizing titan_aro_arp_PAAROME_1S40" in out and "aro_t2m_2m [K]" in out
    assert "Example item" in out
    png = tmp_path / "sample.png"
    assert dataset_cli.main(["titan_aro_arp", "plot", *common, "--output", str(png)]) == 0
    assert png.stat().st_size > 0
    assert dataset_cli.main(["titan_aro_arp", "speedtest", *common, "--n-iter", "3"]) == 0
    out = capsys.readouterr().out
    assert "Loading time of 3 batches" in out and "ms a batch" in out
    with pytest.raises(SystemExit):
        dataset_cli.main(["titan_aro_arp", "unknown"])
