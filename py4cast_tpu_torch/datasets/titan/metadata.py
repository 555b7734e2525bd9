"""Titan dataset metadata: grids and weather parameters.

A copy of the JAX package's ``py4cast_tpu/datasets/titan/metadata.py``.
Grids are AROME (0.01°/0.025°), ARPEGE (0.1°) and the Antilope radar
analysis.
"""

from __future__ import annotations

ISOBARIC_LEVELS_HPA = [
    1000, 950, 925, 900, 850, 800, 750, 700, 650, 600, 550, 500,
    450, 400, 350, 300, 275, 250, 225, 200, 175, 150, 125, 100,
]

#: name → {extent [lat_max, lat_min, lon_min, lon_max], resolution, size,
#:         prefix}
GRIDS = {
    "ANTJP7CLIM_1S100": {
        "extent": [51.5, 41.0, -6.0, 10.5],
        "prefix": "ant",
        "resolution": 0.01,
        "size": (1051, 1651),
    },
    "PAAROME_1S100": {
        "extent": [55.4, 37.5, -12.0, 16.0],
        "prefix": "aro",
        "resolution": 0.01,
        "size": (1791, 2801),
    },
    "PAAROME_1S40": {
        "extent": [55.4, 37.5, -12.0, 16.0],
        "prefix": "aro",
        "resolution": 0.025,
        "size": (717, 1121),
    },
    "PA_01D": {
        "extent": [72.0, 20.0, -32.0, 42.0],
        "prefix": "arp",
        "resolution": 0.1,
        "size": (521, 741),
    },
}


def _param(name, unit, long_name, grid, grib, param, type_level, levels,
           cumulative=False):
    return {
        "name": name,
        "unit": unit,
        "long_name": long_name,
        "grid": grid,
        "grib": grib,
        "param": param,
        "type_level": type_level,
        "levels": levels,
        "cumulative": cumulative,
        "prefix_model": name.split("_")[0],
    }


def _arome_surface_params():
    # (name, unit, long name, grib file suffix, grib param, level type, levels)
    rows = [
        ("aro_t2m", "K", "Arome 2 metre temperature", "ECH0_2M", "t2m",
         "heightAboveGround", [2], False),
        ("aro_r2", "%", "Arome 2 metre relative humidity", "ECH0_2M", "r2",
         "heightAboveGround", [2], False),
        ("aro_u10", "m s**-1", "Arome 10 metre U wind component", "ECH0_10M",
         "u10", "heightAboveGround", [10], False),
        ("aro_v10", "m s**-1", "Arome 10 metre V wind component", "ECH0_10M",
         "v10", "heightAboveGround", [10], False),
        ("aro_ugust", "m s**-1", "Arome U gust", "ECH1_10M", "ugust",
         "heightAboveGround", [10], False),
        ("aro_vgust", "m s**-1", "Arome V gust", "ECH1_10M", "vgust",
         "heightAboveGround", [10], False),
        ("aro_tp", "kg m**-2", "Arome total precipitation", "ECH1_SOL", "tp",
         "surface", [0], True),
        ("aro_tirf", "kg m**-2", "Arome rainfall", "ECH1_SOL", "tirf",
         "surface", [0], True),
        ("aro_sprate", "kg m**-2", "Arome snowfall rate", "ECH1_SOL", "sprate",
         "surface", [0], True),
        ("aro_sd", "m", "Arome snow depth", "ECH0_SOL", "sd",
         "surface", [0], False),
        ("aro_str", "J m**-2", "Arome surface thermal radiation", "ECH1_SOL",
         "str", "surface", [0], True),
        ("aro_ssr", "J m**-2", "Arome surface solar radiation", "ECH1_SOL",
         "ssr", "surface", [0], True),
        ("aro_tciwv", "kg m**-2", "Arome total column water vapour",
         "ECH0_SOL", "tciwv", "surface", [0], False),
        ("aro_prmsl", "Pa", "Arome pressure reduced to MSL", "ECH0_MER",
         "prmsl", "meanSea", [0], False),
    ]
    out = {}
    for name, unit, long_name, suffix, gparam, tl, levels, cml in rows:
        grid = "PAAROME_1S40" if suffix in ("ECH0_MER", "ECH0_SOL") and gparam in (
            "prmsl", "tciwv"
        ) else "PAAROME_1S100"
        out[name] = _param(
            name, unit, long_name, grid,
            f"{grid}_{suffix}.grib", gparam, tl, levels, cml,
        )
    return out


def _arome_isobaric_params():
    rows = [
        ("aro_z", "m**2 s**-2", "Arome geopotential", "z"),
        ("aro_t", "K", "Arome temperature", "t"),
        ("aro_u", "m s**-1", "Arome U wind component", "u"),
        ("aro_v", "m s**-1", "Arome V wind component", "v"),
        ("aro_wz", "m s**-1", "Arome vertical velocity", "wz"),
        ("aro_r", "%", "Arome relative humidity", "r"),
        ("aro_ciwc", "kg kg**-1", "Arome cloud ice water content", "ciwc"),
        ("aro_clwc", "kg kg**-1", "Arome cloud liquid water content", "clwc"),
        ("aro_crwc", "kg kg**-1", "Arome rain water content", "crwc"),
        ("aro_cswc", "kg kg**-1", "Arome snow water content", "cswc"),
    ]
    return {
        name: _param(
            name, unit, long_name, "PAAROME_1S40",
            "PAAROME_1S40_ECH0_ISOBARE.grib", gparam, "isobaricInhPa",
            list(ISOBARIC_LEVELS_HPA),
        )
        for name, unit, long_name, gparam in rows
    }


def _arpege_params():
    rows = [
        ("arp_t2m", "K", "Arpege 2 metre temperature", "PA_01D_2M.grib", "t2m",
         "heightAboveGround", [2]),
        ("arp_r2", "%", "Arpege 2 metre relative humidity", "PA_01D_2M.grib",
         "r2", "heightAboveGround", [2]),
        ("arp_u10", "m s**-1", "Arpege 10 metre U wind", "PA_01D_10M.grib",
         "u10", "heightAboveGround", [10]),
        ("arp_v10", "m s**-1", "Arpege 10 metre V wind", "PA_01D_10M.grib",
         "v10", "heightAboveGround", [10]),
        ("arp_prmsl", "Pa", "Arpege pressure reduced to MSL", "PA_01D_MER.grib",
         "prmsl", "meanSea", [0]),
        ("arp_z", "m**2 s**-2", "Arpege geopotential", "PA_01D_ISOBARE.grib",
         "z", "isobaricInhPa", list(ISOBARIC_LEVELS_HPA)),
        ("arp_t", "K", "Arpege temperature", "PA_01D_ISOBARE.grib", "t",
         "isobaricInhPa", list(ISOBARIC_LEVELS_HPA)),
        ("arp_u", "m s**-1", "Arpege U wind component", "PA_01D_ISOBARE.grib",
         "u", "isobaricInhPa", list(ISOBARIC_LEVELS_HPA)),
        ("arp_v", "m s**-1", "Arpege V wind component", "PA_01D_ISOBARE.grib",
         "v", "isobaricInhPa", list(ISOBARIC_LEVELS_HPA)),
        ("arp_r", "%", "Arpege relative humidity", "PA_01D_ISOBARE.grib", "r",
         "isobaricInhPa", list(ISOBARIC_LEVELS_HPA)),
    ]
    return {
        name: _param(name, unit, long_name, "PA_01D", grib, gparam, tl, levels)
        for name, unit, long_name, grib, gparam, tl, levels in rows
    }


WEATHER_PARAMS = {
    "ant_prec": _param(
        "ant_prec", "kg m**-2", "Antilope Precipitation", "ANTJP7CLIM_1S100",
        "ANTJP7CLIM_1S100_60_SOL.grib", "prec", "surface", [0], True,
    ),
    **_arome_surface_params(),
    **_arome_isobaric_params(),
    **_arpege_params(),
}

METADATA = {
    "GRIDS": GRIDS,
    "WEATHER_PARAMS": WEATHER_PARAMS,
    "ISOBARIC_LEVELS_HPA": ISOBARIC_LEVELS_HPA,
}
