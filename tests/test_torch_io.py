"""The port's product export against the JAX package, on the CPU: the
GRIB2 codec byte for byte (and against the committed WMO FM 92 golden
message), ``match_latlon`` / ``fill_tensor_with`` / ``feature2fid``,
the template workflow with ``make_template``, ``save_predictions`` on
Dummy (grid and graph layouts), GIF export, the CLI's ``predict`` with
``data.save_gribs``, and the dataset's ``domain_info``.

Bars: bytes are equal; values read back from a GRIB file are within
the simple packing's quantum ((max - min) / (2^16 - 1), doubled by the
binary scale's rounding up to a power of two)."""

import datetime as dt
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from py4cast_tpu.datasets import get_datasets as jax_get_datasets
from py4cast_tpu.io import grib2 as jax_grib2
from py4cast_tpu.io import outputs as jax_outputs
from py4cast_tpu.named_tensor import NamedArray as JaxNamedArray
from py4cast_tpu_torch import cli
from py4cast_tpu_torch.datasets import get_datasets as port_get_datasets
from py4cast_tpu_torch.io import grib2, outputs
from py4cast_tpu_torch.named_tensor import NamedArray

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_PATH = ROOT / "tests" / "data" / "golden_fm92.grib2"
sys.path.insert(0, str(ROOT / "tests"))
from golden_grib2 import GOLDEN_LAT, GOLDEN_LON, GOLDEN_VALUES  # noqa: E402


def _fields(mod, rng):
    """The same fields as ``mod.Grib2Field``s: ascending and descending
    grids, a bitmap, pdt 8, a constant field, 8/16/24-bit packing."""
    lat = np.linspace(50.0, 40.0, 21)
    lon = np.linspace(-6.0, 4.0, 17)
    values = rng.uniform(250.0, 310.0, (21, 17))
    masked = np.ma.masked_invalid(np.where(values > 290.0, np.nan, values))
    return [
        mod.Grib2Field(values=values, lat=lat, lon=lon, type_of_level=103, level=2,
                       data_date=dt.date(2023, 3, 1), data_time=(6, 0), forecast_hours=12),
        mod.Grib2Field(values=masked, lat=lat[::-1], lon=lon, bits_per_value=8),
        mod.Grib2Field(values=values * 1e-3, lat=lat, lon=lon[::-1], parameter_category=1,
                       parameter_number=8, pdt=8, length_of_time_range=3, forecast_hours=6,
                       bits_per_value=24),
        mod.Grib2Field(values=np.full((21, 17), 7.25), lat=lat, lon=lon, type_of_level=100,
                       level=850.0),
    ]


@pytest.mark.parametrize("index", range(4))
def test_grib_writer_matches_the_jax_writer_byte_for_byte(tmp_path, index):
    port_field = _fields(grib2, np.random.default_rng(0))[index]
    jax_field = _fields(jax_grib2, np.random.default_rng(0))[index]
    got = grib2.write_grib2(tmp_path / "port.grib2", [port_field]).read_bytes()
    want = jax_grib2.write_grib2(tmp_path / "jax.grib2", [jax_field]).read_bytes()
    assert got == want
    (back,) = grib2.read_grib2(tmp_path / "port.grib2")
    (jax_back,) = jax_grib2.read_grib2(tmp_path / "jax.grib2")
    np.testing.assert_array_equal(np.ma.filled(back.values, -1), np.ma.filled(jax_back.values, -1))
    assert back.param_key() == jax_back.param_key()


def test_golden_message_reads_back_and_rewrites_byte_for_byte(tmp_path):
    (f,) = grib2.read_grib2(GOLDEN_PATH)
    np.testing.assert_array_equal(np.asarray(f.values), GOLDEN_VALUES)
    np.testing.assert_allclose(f.lat, GOLDEN_LAT, atol=1e-6)
    np.testing.assert_allclose(f.lon, GOLDEN_LON, atol=1e-6)
    assert (f.type_of_level, f.level, f.forecast_hours, f.bits_per_value) == (100, 850.0, 3, 8)
    assert f.validity_time() == dt.datetime(2024, 3, 1, 9, 0)
    out = grib2.write_grib2(tmp_path / "re.grib2", [f])
    assert out.read_bytes() == GOLDEN_PATH.read_bytes()


@pytest.mark.parametrize("case", ["exact", "embedded", "descending", "outside"])
def test_match_latlon_and_fill_match_jax(case):
    tlat = np.linspace(30, 60, 31)
    tlon = np.linspace(-10, 20, 31)
    glat, glon = {
        "exact": (tlat, tlon),
        "embedded": (tlat[5:16], tlon[3:14]),
        "descending": (tlat[5:16][::-1], tlon[3:14]),
        "outside": (np.linspace(61, 70, 10), tlon),
    }[case]
    if case == "outside":
        with pytest.raises(ValueError, match="not embeddable"):
            outputs.match_latlon(glat, glon, tlat, tlon)
        return
    got = outputs.match_latlon(glat, glon, tlat, tlon)
    assert got == jax_outputs.match_latlon(glat, glon, tlat, tlon)
    vals = np.random.default_rng(1).standard_normal((len(glat), len(glon))).astype(np.float32)
    filled = outputs.fill_tensor_with((31, 31), vals, *got)
    want = jax_outputs.fill_tensor_with((31, 31), vals, *got)
    np.testing.assert_array_equal(np.ma.getmaskarray(filled), np.ma.getmaskarray(want))
    np.testing.assert_array_equal(filled.compressed(), want.compressed())


def test_feature2fid_matches_jax():
    assert outputs.FEATURE2GRIB == jax_outputs.FEATURE2GRIB
    assert grib2.LEVEL_TYPE_CODES == jax_grib2.LEVEL_TYPE_CODES
    names = [f"aro_{v}_{lv}_{t}" for v in list(outputs.FEATURE2GRIB) + ["foo", "dummy"]
             for lv, t in ((2, "heightAboveGround"), (500, "isobaricInhPa"), (0, "surface"))]
    names += ["nounderscores", "a_b_badlevel", "a_b_1_unknownType",
              "dummy_parameter_500_isobaricInhPa"]
    for name in names:
        for hours in (1, 3):
            assert outputs.feature2fid(name, hours) == jax_outputs.feature2fid(name, hours), name
    want = jax_outputs.template_fids_for_features(names)
    assert outputs.template_fids_for_features(names) == want


@pytest.mark.parametrize("path,kwargs,ids,ok", [
    ("{}/{}.grib", ("run",), ("date",), True),
    ("{}/{}/{}.grib", ("run",), ("date",), False),
    ("{}.grib", ("run",), ("date",), False),
])
def test_output_settings_placeholder_validation(path, kwargs, ids, ok):
    def mk():
        return outputs.OutputSavingSettings(path_to_runtime=path, output_kwargs=kwargs,
                                            sample_identifiers=ids)

    if ok:
        assert mk().get_path("20240101") == "run/20240101.grib"
    else:
        with pytest.raises(ValueError, match="placeholders"):
            mk()


class _FakeGrid:
    def __init__(self, lat_1d, lon_1d):
        self.lat = np.tile(lat_1d[:, None], (1, len(lon_1d)))
        self.lon = np.tile(lon_1d[None, :], (len(lat_1d), 1))


@pytest.mark.parametrize("ascending", [False, True])
def test_template_export_matches_jax(tmp_path, ascending):
    """A 40x40 template from make_template, the model grid an inner
    16x16 block (rows flipped when the model grid ascends): the port's
    files equal the JAX writer's, the block reads back within the
    packing quantum and the rest is masked."""
    tlat = np.linspace(55.0, 35.5, 40)
    tlon = np.linspace(-10.0, 9.5, 40)
    glat = tlat[10:26][::-1] if ascending else tlat[10:26]
    glon = tlon[8:24]
    features = ("aro_t2m_2_heightAboveGround", "aro_tp_0_surface")
    template = tmp_path / "template.grib"
    grib2.make_template(template, tlat, tlon, outputs.template_fids_for_features(features))
    jax_template = tmp_path / "jax_template.grib"
    jax_grib2.make_template(jax_template, tlat, tlon,
                            jax_outputs.template_fids_for_features(features))
    assert template.read_bytes() == jax_template.read_bytes()

    data = np.random.default_rng(3).uniform(260, 300, (2, 16, 16, 2)).astype(np.float32)
    t0 = dt.datetime(2023, 6, 1, 12)
    validity = [t0 + dt.timedelta(hours=h) for h in (1, 2)]
    names = ("timestep", "lat", "lon", "features")
    written = {}
    for tag, mod, named in (("port", outputs, NamedArray), ("jax", jax_outputs, JaxNamedArray)):
        settings = mod.OutputSavingSettings(
            template_grib=str(template), directory=str(tmp_path / tag), output_kwargs=("run",),
            sample_identifiers=("date", "leadtime"), path_to_runtime="{}/{}_+{}h.grib")
        written[tag] = mod.save_named_tensors_to_grib(
            named(data, names, features), _FakeGrid(glat, glon), validity, settings,
            sample_identifiers=("20230601T12",), base_datetime=t0, time_step_hours=1)
    assert [p.name for p in written["port"]] == ["20230601T12_+1h.grib", "20230601T12_+2h.grib"]
    for got, want in zip(written["port"], written["jax"]):
        assert got.read_bytes() == want.read_bytes()
    fields = grib2.read_grib2(written["port"][0])
    t2m = [f for f in fields if f.parameter_number == 0][0]
    assert t2m.values.shape == (40, 40) and t2m.values.count() == 16 * 16
    block = np.asarray(t2m.values[10:26, 8:24])
    want = data[0, ::-1, :, 0] if ascending else data[0, :, :, 0]
    quantum = 2 * (want.max() - want.min()) / (2**16 - 1)
    np.testing.assert_allclose(block, want, atol=quantum)
    tp = [f for f in fields if f.parameter_number == 8][0]
    assert tp.pdt == 8 and tp.length_of_time_range == 1


def test_template_missing_warns_and_skips(tmp_path):
    settings = outputs.OutputSavingSettings(template_grib=str(tmp_path / "nope.grib"),
                                            directory=str(tmp_path), sample_identifiers=("date",),
                                            path_to_runtime="{}.grib")
    pred = NamedArray(np.zeros((1, 4, 4, 1), np.float32), ("timestep", "lat", "lon", "features"),
                      ("aro_t2m_2_heightAboveGround",))
    grid = _FakeGrid(np.linspace(4, 1, 4), np.linspace(0, 3, 4))
    with pytest.warns(UserWarning, match="template_grib"):
        out = outputs.save_named_tensors_to_grib(pred, grid, [dt.datetime(2023, 1, 1, 1)],
                                                 settings, ("d",))
    assert out == []


@pytest.fixture(scope="module")
def dummy_sets():
    return jax_get_datasets("dummy", 2, 1, 3)[2], port_get_datasets("dummy", 2, 1, 3)[2]


def test_domain_info_matches_the_jax_dataset(dummy_sets):
    jax_ds, port_ds = dummy_sets
    got, want = port_ds.dataset_info.domain_info, jax_ds.dataset_info.domain_info
    assert got.grid_limits == want.grid_limits == port_ds.grid.grid_limits
    # no cartopy here: no projection in either package
    assert got.projection is None and want.projection is None


def _io_conf(tmp_path, grid, feature_names) -> Path:
    """A template for the Dummy grid and the io_conf JSON pointing at it."""
    template = tmp_path / "template.grib"
    grib2.make_template(template, grid.lat[:, 0], grid.lon[0],
                        outputs.template_fids_for_features(feature_names))
    conf = tmp_path / "io.json"
    conf.write_text(json.dumps({
        "template_grib": str(template), "directory": str(tmp_path / "gribs"),
        "output_kwargs": ["dummy"], "sample_identifiers": ["date", "sample", "leadtime"],
        "path_to_runtime": "{}/{}_{}_+{}h.grib"}))
    return conf


def test_save_predictions_matches_jax_in_grid_and_graph_layout(dummy_sets, tmp_path):
    """Two batches of Dummy predictions (8 and a tail of 4) through both
    packages' save_predictions: the same files with the same bytes; the
    GRAPH layout (ngrid) gives the grid layout's bytes."""
    jax_ds, port_ds = dummy_sets
    names = port_ds.dataset_info.output_feature_names
    conf = _io_conf(tmp_path, port_ds.grid, names)
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((n, 3, 64, 64, 1)).astype(np.float32) for n in (8, 4)]
    dims = ("batch", "timestep", "lat", "lon", "features")
    runs = {
        "jax": (jax_outputs, [JaxNamedArray(b, dims, names) for b in batches], jax_ds),
        "grid": (outputs, [NamedArray(b, dims, names) for b in batches], port_ds),
        "graph": (outputs, [NamedArray(torch.from_numpy(b.reshape(b.shape[0], 3, -1, 1)),
                                       ("batch", "timestep", "ngrid", "features"), names)
                            for b in batches], port_ds),
    }
    files = {}
    for tag, (mod, preds, ds) in runs.items():
        settings = json.loads(conf.read_text())
        settings["directory"] = str(tmp_path / tag)
        conf_tag = tmp_path / f"{tag}.json"
        conf_tag.write_text(json.dumps(settings))
        mod.save_predictions(preds, ds, tmp_path / tag, save_gribs=True, io_conf=str(conf_tag))
        files[tag] = {p.relative_to(tmp_path / tag): p.read_bytes()
                      for p in sorted((tmp_path / tag).rglob("*.grib"))}
    assert len(files["jax"]) == 12 * 3  # 12 samples x 3 leadtimes
    assert files["grid"] == files["jax"]
    assert files["graph"] == files["jax"]


def test_save_gifs_writes_one_gif_a_feature(tmp_path):
    pred = NamedArray(np.random.default_rng(0).standard_normal((3, 16, 16, 2)).astype(np.float32),
                      ("timestep", "lat", "lon", "features"), ("a_1_surface", "b_1_surface"))
    paths = outputs.save_gifs(pred, tmp_path, prefix="x")
    assert [p.name for p in paths] == ["x_a_1_surface.gif", "x_b_1_surface.gif"]
    assert all(p.stat().st_size > 0 for p in paths)


def test_gifs_without_matplotlib_raise_an_import_error_naming_it(dummy_sets, tmp_path,
                                                                 monkeypatch):
    _, port_ds = dummy_sets
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pred = NamedArray(np.zeros((1, 3, 64, 64, 1), np.float32),
                      ("batch", "timestep", "lat", "lon", "features"),
                      port_ds.dataset_info.output_feature_names)
    with pytest.raises(ImportError, match="matplotlib"):
        outputs.save_predictions([pred], port_ds, tmp_path, save_gifs=True)
    assert not (tmp_path / "gifs").exists()


def test_cli_predict_writes_gribs_that_read_back(dummy_sets, tmp_path):
    """fit a narrow HalfUNet through the CLI, then predict with
    data.save_gribs: every sample's three leadtimes are GRIB files whose
    Dummy block equals the .npy predictions within the packing quantum."""
    _, port_ds = dummy_sets
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
               "--config", str(ROOT / "config/CLI/model/halfunet.yaml"),
               "--trainer.device", "cpu", "--trainer.save_path", str(tmp_path / "run"),
               "--data.num_workers", "1"]
    assert cli.main(["fit", *configs, "--model.settings_init_args.num_filters", "4",
                     "--trainer.max_epochs", "1", "--trainer.limit_train_batches", "1",
                     "--trainer.limit_val_batches", "1", "--trainer.logging_enabled",
                     "false"]) == 0
    conf = _io_conf(tmp_path, port_ds.grid, port_ds.dataset_info.output_feature_names)
    assert cli.main(["predict", *configs, "--trainer.ckpt_path", "last",
                     "--data.save_gribs", "true", "--model.io_conf", str(conf)]) == 0
    preds = np.concatenate([np.load(p) for p in
                            sorted((tmp_path / "run" / "predictions").glob("batch_*.npy"))])
    samples = port_ds.sample_list
    assert len(samples) == preds.shape[0]
    for i in (0, len(samples) - 1):
        date = samples[i].timestamps.datetime.strftime("%Y%m%d%H")
        tag = f"b{i // 8}_s{i % 8}"
        for t in range(3):
            path = tmp_path / "gribs" / "dummy" / f"{date}_{tag}_+{t + 1}h.grib"
            (field,) = grib2.read_grib2(path)
            want = preds[i, t, :, :, 0]
            quantum = 2 * (want.max() - want.min()) / (2**16 - 1)
            np.testing.assert_allclose(np.asarray(field.values), want, atol=quantum)
