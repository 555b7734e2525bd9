"""Time and solar forcing generation (host-side numpy).

- calendar forcing: sin/cos of hour-of-day and of year fraction,
  rescaled to [0, 1];
- TOA solar irradiance: E0 * cos(solar zenith angle), clamped at 0,
  with E0 = 1366 W/m^2 and the declination formula of Duffie & Beckman
  (Solar Engineering of Thermal Processes, eq. 1.6.1a/1.6.2).
"""

from __future__ import annotations

import datetime as dt
from typing import List

import numpy as np

from py4cast_tpu_torch.named_tensor import NamedArray

SOLAR_CONSTANT = 1366.0  # W / m^2


def compute_day_of_years(date: dt.datetime, terms: List[dt.timedelta]) -> np.ndarray:
    """Day of year per term; 1st of January is day 1."""
    days = []
    for term in terms:
        d = date + term
        days.append((d - dt.datetime(d.year, 1, 1)).days + 1)
    return np.asarray(days, dtype=np.float64)


def compute_hours_of_day(date: dt.datetime, terms: List[dt.timedelta]) -> np.ndarray:
    hours = []
    for term in terms:
        d = date + term
        hours.append(d.hour + d.minute / 60)
    return np.asarray(hours, dtype=np.float64)


def compute_seconds_from_start_of_year(
    date: dt.datetime, terms: List[dt.timedelta]
) -> np.ndarray:
    start = dt.datetime(date.year, 1, 1)
    return np.asarray(
        [(date + term - start).total_seconds() for term in terms], dtype=np.float64
    )


def get_year_hour_forcing(date: dt.datetime, terms: List[dt.timedelta]) -> np.ndarray:
    """(T, 4) array: [sin_hour, cos_hour, sin_year, cos_year], in [0, 1]."""
    hours = compute_hours_of_day(date, terms)
    seconds = compute_seconds_from_start_of_year(date, terms)
    days_in_year = 366 if date.year % 4 == 0 else 365
    seconds_in_year = days_in_year * 24 * 3600

    hour_angle = hours / 12.0 * np.pi
    year_angle = seconds / seconds_in_year * 2.0 * np.pi
    f = np.stack(
        [
            np.sin(hour_angle),
            np.cos(hour_angle),
            np.sin(year_angle),
            np.cos(year_angle),
        ],
        axis=1,
    )
    return ((f + 1.0) / 2.0).astype(np.float32)


def generate_toa_radiation_forcing(
    lat: np.ndarray,
    lon: np.ndarray,
    date_utc: dt.datetime,
    terms: List[dt.timedelta],
) -> np.ndarray:
    """(T, lat, lon, 1) top-of-atmosphere solar irradiance, W/m^2."""
    day_of_years = compute_day_of_years(date_utc, terms)
    hours = compute_hours_of_day(date_utc, terms)

    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)

    # local solar hour from UTC via longitude (15 deg per hour)
    hours_lcl = hours[:, None, None] + lon[None] / 15.0
    omega_rad = np.radians(15.0 * (hours_lcl - 12.0))

    dec_rad = np.radians(
        23.45 * np.sin(2 * np.pi * (284.0 + day_of_years) / 365.0)
    )[:, None, None]
    phi_rad = np.radians(lat)[None]

    cos_sza = np.sin(phi_rad) * np.sin(dec_rad) + np.cos(phi_rad) * np.cos(
        dec_rad
    ) * np.cos(omega_rad)
    toa = np.maximum(0.0, SOLAR_CONSTANT * cos_sza)
    return toa[..., None].astype(np.float32)


def generate_forcings(
    date: dt.datetime, timedeltas: List[dt.timedelta], grid
) -> List[NamedArray]:
    """All generated forcings for one sample, as NamedArrays: two
    2-feature calendar tensors [cos_hour, sin_hour], [cos_doy, sin_doy]
    (column 0 holds the sine; the names are kept for feature-name
    parity) plus the gridded solar forcing."""
    calendar = get_year_hour_forcing(date, timedeltas)  # (T, 4)
    solar = generate_toa_radiation_forcing(grid.lat, grid.lon, date, timedeltas)
    return [
        NamedArray(calendar[:, :2], ("timestep", "features"), ("cos_hour", "sin_hour")),
        NamedArray(calendar[:, 2:], ("timestep", "features"), ("cos_doy", "sin_doy")),
        NamedArray(solar, ("timestep", "lat", "lon", "features"), ("toa_radiation",)),
    ]
