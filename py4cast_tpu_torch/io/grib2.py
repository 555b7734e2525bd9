"""Minimal, dependency-free GRIB2 codec (regular lat/lon grids).

The port's own copy of the JAX package's codec (numpy only): a field
written here is byte-identical to one written there. It implements the
GRIB2 wire format (WMO FM 92) for the subset the framework needs:

- Section 3 template 3.0 (regular latitude/longitude grid)
- Section 4 templates 4.0 (instant) and 4.8 (accumulated/statistical)
- Section 5 template 5.0 (grid-point simple packing), any bit width
- Section 6 bitmaps (for fields masked outside the model subdomain)

Files produced are standard GRIB2 messages readable by eccodes/cfgrib.
The reader handles the same subset: enough to read operational-style
templates regenerated with :func:`make_template` and anything this
module wrote.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import math
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

#: GRIB2 code table 4.5 — fixed-surface types used by py4cast level types
LEVEL_TYPE_CODES = {
    "surface": 1,
    "isobaricInhPa": 100,
    "meanSea": 101,
    "heightAboveGround": 103,
}
LEVEL_TYPE_NAMES = {v: k for k, v in LEVEL_TYPE_CODES.items()}


def _u(value: int, width: int) -> bytes:
    return int(value).to_bytes(width, "big")


def _s(value: int, width: int) -> bytes:
    """GRIB2 signed integers are sign-and-magnitude, MSB = sign."""
    v = int(value)
    if v < 0:
        return _u((1 << (8 * width - 1)) | (-v), width)
    return _u(v, width)


def _read_u(buf: bytes, off: int, width: int) -> int:
    return int.from_bytes(buf[off : off + width], "big")


def _read_s(buf: bytes, off: int, width: int) -> int:
    raw = _read_u(buf, off, width)
    sign_bit = 1 << (8 * width - 1)
    if raw & sign_bit:
        return -(raw & (sign_bit - 1))
    return raw


@dataclass
class Grib2Field:
    """One decoded/encodable GRIB2 message on a regular lat/lon grid.

    ``values`` is (Nj, Ni) with row j at ``lat[j]`` and column i at
    ``lon[i]`` — masked entries are encoded through a bitmap.
    """

    values: np.ndarray  # (Nj, Ni), possibly np.ma.MaskedArray
    lat: np.ndarray  # (Nj,), degrees, either orientation
    lon: np.ndarray  # (Ni,), degrees in [-180, 180)
    discipline: int = 0
    parameter_category: int = 0
    parameter_number: int = 0
    type_of_level: int = 1  # code table 4.5
    level: float = 0.0  # hPa for isobaric, metres for heightAboveGround
    data_date: dt.date = field(default_factory=lambda: dt.date(2000, 1, 1))
    data_time: Tuple[int, int] = (0, 0)  # (hour, minute) of the reference
    forecast_hours: int = 0
    pdt: int = 0  # product definition template: 0 (instant) or 8 (accum)
    stat_processing: int = 1  # accumulation, for pdt 8
    length_of_time_range: int = 1  # hours, for pdt 8
    centre: int = 85  # Météo-France (LFPW)
    bits_per_value: int = 16

    # ------------------------------------------------------------- helpers
    @property
    def type_of_level_name(self) -> str:
        return LEVEL_TYPE_NAMES.get(self.type_of_level, str(self.type_of_level))

    def param_key(self) -> Tuple[int, int, int, int, float]:
        return (
            self.discipline,
            self.parameter_category,
            self.parameter_number,
            self.type_of_level,
            float(self.level),
        )

    def validity_time(self) -> dt.datetime:
        base = dt.datetime(
            self.data_date.year, self.data_date.month, self.data_date.day,
            self.data_time[0], self.data_time[1],
        )
        return base + dt.timedelta(hours=self.forecast_hours)


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------

def _pack_bits(codes: np.ndarray, nbits: int) -> bytes:
    shifts = np.arange(nbits - 1, -1, -1, dtype=np.uint32)
    bits = ((codes[:, None].astype(np.uint64) >> shifts) & 1).astype(np.uint8)
    return np.packbits(bits.ravel()).tobytes()


def _unpack_bits(data: bytes, n: int, nbits: int) -> np.ndarray:
    if nbits == 0:
        return np.zeros(n, np.int64)
    bits = np.unpackbits(np.frombuffer(data, np.uint8))[: n * nbits]
    weights = (1 << np.arange(nbits - 1, -1, -1, dtype=np.int64))
    return bits.reshape(n, nbits).astype(np.int64) @ weights


def _simple_pack(valid: np.ndarray, nbits: int):
    """Simple packing (template 5.0, D=0): v = R + X * 2**E."""
    if valid.size == 0:
        return 0.0, 0, 0, np.zeros(0, np.int64)
    vmin = float(valid.min())
    vmax = float(valid.max())
    if vmax == vmin:
        return vmin, 0, 0, np.zeros(valid.size, np.int64)
    e = math.ceil(math.log2((vmax - vmin) / ((1 << nbits) - 1)))
    codes = np.clip(
        np.round((valid.astype(np.float64) - vmin) / 2.0**e),
        0,
        (1 << nbits) - 1,
    ).astype(np.int64)
    return vmin, e, nbits, codes


def _encode_section3(f: Grib2Field) -> bytes:
    nj, ni = f.values.shape
    lat = np.asarray(f.lat, np.float64)
    lon = np.asarray(f.lon, np.float64)
    la1, la2 = lat[0], lat[-1]
    lo1, lo2 = lon[0] % 360.0, lon[-1] % 360.0
    di = abs(lon[1] - lon[0]) if ni > 1 else 1.0
    dj = abs(lat[1] - lat[0]) if nj > 1 else 1.0
    scan = 0
    if ni > 1 and lon[1] < lon[0]:
        scan |= 0x80  # -i direction
    if nj > 1 and lat[1] > lat[0]:
        scan |= 0x40  # +j direction
    tpl = b"".join([
        _u(6, 1),  # shapeOfEarth: spherical r=6371229
        _u(0xFF, 1), _u(0xFFFFFFFF, 4),  # radius scale/value: missing
        _u(0xFF, 1), _u(0xFFFFFFFF, 4),  # major axis
        _u(0xFF, 1), _u(0xFFFFFFFF, 4),  # minor axis
        _u(ni, 4), _u(nj, 4),
        _u(0, 4), _u(0, 4),  # basic angle + subdivisions
        _s(round(la1 * 1e6), 4), _u(round(lo1 * 1e6), 4),
        _u(0x30, 1),  # resolution/component flags: di & dj given
        _s(round(la2 * 1e6), 4), _u(round(lo2 * 1e6), 4),
        _u(round(di * 1e6), 4), _u(round(dj * 1e6), 4),
        _u(scan, 1),
    ])
    body = b"".join([
        _u(3, 1),  # section number
        _u(0, 1),  # source of grid definition
        _u(ni * nj, 4),
        _u(0, 1), _u(0, 1),  # no optional list
        _u(0, 2),  # grid definition template 3.0
        tpl,
    ])
    return _u(4 + len(body), 4) + body


def _level_scaling(f: Grib2Field) -> Tuple[int, int]:
    if f.type_of_level == 100:  # isobaric: level is hPa, encode Pa
        return 0, int(round(f.level * 100))
    return 0, int(round(f.level))


def _encode_section4(f: Grib2Field) -> bytes:
    sf, sv = _level_scaling(f)
    base = b"".join([
        _u(f.parameter_category, 1),
        _u(f.parameter_number, 1),
        _u(2, 1),  # generating process: forecast
        _u(255, 1), _u(255, 1),  # background/process id
        _u(0, 2), _u(0, 1),  # data cutoff
        _u(1, 1),  # time unit: hour
        _u(f.forecast_hours, 4),
        _u(f.type_of_level, 1), _u(sf, 1), _u(sv, 4),
        _u(255, 1), _u(255, 1), _u(0xFFFFFFFF, 4),  # no second surface
    ])
    if f.pdt == 8:
        end = f.validity_time()
        base += b"".join([
            _u(end.year, 2), _u(end.month, 1), _u(end.day, 1),
            _u(end.hour, 1), _u(end.minute, 1), _u(end.second, 1),
            _u(1, 1),  # one time range
            _u(0, 4),  # no missing values in statistics
            _u(f.stat_processing, 1),
            _u(2, 1),  # time increment type: same start, fcst time incr.
            _u(1, 1),  # range unit: hour
            _u(f.length_of_time_range, 4),
            _u(255, 1), _u(0, 4),  # no increment
        ])
    body = _u(4, 1) + _u(0, 2) + _u(f.pdt, 2) + base
    return _u(4 + len(body), 4) + body


def _encode_message(f: Grib2Field) -> bytes:
    values = np.ma.asarray(f.values, np.float64)
    nj, ni = values.shape
    mask = np.ma.getmaskarray(values)
    has_bitmap = bool(mask.any())
    valid = values.compressed() if has_bitmap else np.asarray(values).ravel()

    ref, e, nbits, codes = _simple_pack(valid, f.bits_per_value)

    sec1 = _u(1, 1) + b"".join([
        _u(f.centre, 2), _u(0, 2),  # centre / subcentre
        _u(2, 1), _u(1, 1),  # tables version / local tables
        _u(1, 1),  # significance of ref time: start of forecast
        _u(f.data_date.year, 2), _u(f.data_date.month, 1),
        _u(f.data_date.day, 1),
        _u(f.data_time[0], 1), _u(f.data_time[1], 1), _u(0, 1),
        _u(0, 1), _u(1, 1),  # production status / processed data type
    ])
    sec1 = _u(4 + len(sec1), 4) + sec1

    sec3 = _encode_section3(f)
    sec4 = _encode_section4(f)

    sec5 = _u(5, 1) + b"".join([
        _u(valid.size, 4),
        _u(0, 2),  # data representation template 5.0
        struct.pack(">f", ref),
        _s(e, 2), _s(0, 2),  # binary / decimal scale factors
        _u(nbits, 1),
        _u(0, 1),  # original field type: float
    ])
    sec5 = _u(4 + len(sec5), 4) + sec5

    if has_bitmap:
        bitmap_bits = np.packbits((~mask).astype(np.uint8).ravel()).tobytes()
        sec6 = _u(6 + len(bitmap_bits), 4) + _u(6, 1) + _u(0, 1) + bitmap_bits
    else:
        sec6 = _u(6, 4) + _u(6, 1) + _u(255, 1)

    packed = _pack_bits(codes, nbits) if nbits else b""
    sec7 = _u(5 + len(packed), 4) + _u(7, 1) + packed

    payload = sec1 + sec3 + sec4 + sec5 + sec6 + sec7
    total = 16 + len(payload) + 4
    sec0 = b"GRIB" + _u(0, 2) + _u(f.discipline, 1) + _u(2, 1) + _u(total, 8)
    return sec0 + payload + b"7777"


def write_grib2(path: Union[str, Path], fields: Sequence[Grib2Field]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fout:
        for f in fields:
            fout.write(_encode_message(f))
    return path


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------

def _decode_lon(lo_micro: int) -> float:
    lo = lo_micro / 1e6
    return lo - 360.0 if lo >= 180.0 else lo


def _decode_message(buf: bytes) -> Tuple[Grib2Field, int]:
    if buf[:4] != b"GRIB":
        raise ValueError("Not a GRIB message")
    discipline = buf[6]
    if buf[7] != 2:
        raise ValueError(f"Only GRIB edition 2 is supported, got {buf[7]}")
    total = _read_u(buf, 8, 8)

    sections = {}
    off = 16
    while off < total - 4:
        length = _read_u(buf, off, 4)
        number = buf[off + 4]
        sections[number] = buf[off : off + length]
        off += length
    if buf[total - 4 : total] != b"7777":
        raise ValueError("GRIB message missing 7777 trailer")

    s1 = sections[1]
    centre = _read_u(s1, 5, 2)
    date = dt.date(_read_u(s1, 12, 2), s1[14], s1[15])
    time = (s1[16], s1[17])

    s3 = sections[3]
    if _read_u(s3, 12, 2) != 0:
        raise ValueError("Only grid template 3.0 (regular lat/lon) supported")
    t = 14  # template start
    ni = _read_u(s3, t + 16, 4)
    nj = _read_u(s3, t + 20, 4)
    la1 = _read_s(s3, t + 32, 4) / 1e6
    lo1 = _decode_lon(_read_u(s3, t + 36, 4))
    la2 = _read_s(s3, t + 41, 4) / 1e6
    lo2raw = _read_u(s3, t + 45, 4) / 1e6
    scan = s3[t + 57]
    i_neg = bool(scan & 0x80)
    lo1u = lo1 % 360.0
    lo2u = lo2raw % 360.0
    if not i_neg and lo2u < lo1u:
        lo2u += 360.0
    if i_neg and lo2u > lo1u:
        lo2u -= 360.0
    lon = np.linspace(lo1u, lo2u, ni)
    lon = np.where(lon >= 180.0, lon - 360.0, lon)
    lat = np.linspace(la1, la2, nj)

    s4 = sections[4]
    pdt = _read_u(s4, 7, 2)
    if pdt not in (0, 8):
        raise ValueError(f"Only product templates 4.0/4.8 supported, got {pdt}")
    category = s4[9]
    number = s4[10]
    forecast_hours = _read_u(s4, 18, 4)
    type_of_level = s4[22]
    sv = _read_u(s4, 24, 4)
    level = sv / 100.0 if type_of_level == 100 else float(sv)
    stat_processing = 1
    length_of_time_range = 1
    if pdt == 8:
        stat_processing = s4[46]
        length_of_time_range = _read_u(s4, 49, 4)

    s5 = sections[5]
    n_valid = _read_u(s5, 5, 4)
    if _read_u(s5, 9, 2) != 0:
        raise ValueError("Only data representation template 5.0 supported")
    ref = struct.unpack(">f", s5[11:15])[0]
    e = _read_s(s5, 15, 2)
    d = _read_s(s5, 17, 2)
    nbits = s5[19]

    s6 = sections[6]
    bitmap_flag = s6[5]
    if bitmap_flag == 0:
        bits = np.unpackbits(np.frombuffer(s6[6:], np.uint8))[: ni * nj]
        present = bits.astype(bool)
    elif bitmap_flag == 255:
        present = np.ones(ni * nj, bool)
    else:
        raise ValueError(f"Unsupported bitmap indicator {bitmap_flag}")

    s7 = sections[7]
    codes = _unpack_bits(s7[5:], n_valid, nbits)
    vals = (ref + codes.astype(np.float64) * 2.0**e) / 10.0**d

    flat = np.full(ni * nj, np.nan)
    flat[present] = vals
    values = np.ma.masked_invalid(flat.reshape(nj, ni))

    return (
        Grib2Field(
            values=values, lat=lat, lon=lon, discipline=discipline,
            parameter_category=category, parameter_number=number,
            type_of_level=type_of_level, level=level, data_date=date,
            data_time=time, forecast_hours=forecast_hours, pdt=pdt,
            stat_processing=stat_processing,
            length_of_time_range=length_of_time_range, centre=centre,
            bits_per_value=nbits or 16,
        ),
        total,
    )


def read_grib2(path: Union[str, Path]) -> List[Grib2Field]:
    data = Path(path).read_bytes()
    fields = []
    off = 0
    while off < len(data):
        start = data.find(b"GRIB", off)
        if start < 0:
            break
        f, consumed = _decode_message(data[start:])
        fields.append(f)
        off = start + consumed
    return fields


# --------------------------------------------------------------------------
# template generation
# --------------------------------------------------------------------------

def make_template(
    path: Union[str, Path],
    lat: np.ndarray,
    lon: np.ndarray,
    fids: Sequence[dict],
    fill_value: float = 0.0,
) -> Path:
    """Generate a template GRIB akin to an operational analysis file: one
    constant-valued message per parameter id on the given grid. The
    product writer reads it back, embeds predictions into each matching
    field, and re-encodes."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    base = np.full((lat.size, lon.size), fill_value, np.float64)
    fields = []
    for fid in fids:
        type_of_level = fid.get("typeOfFirstFixedSurface", 1)
        if isinstance(type_of_level, str):
            type_of_level = LEVEL_TYPE_CODES[type_of_level]
        fields.append(
            Grib2Field(
                values=base.copy(),
                lat=lat,
                lon=lon,
                discipline=fid.get("discipline", 0),
                parameter_category=fid.get("parameterCategory", 0),
                parameter_number=fid.get("parameterNumber", 0),
                type_of_level=type_of_level,
                level=fid.get("level", 0),
                pdt=fid.get("productDefinitionTemplateNumber", 0),
            )
        )
    return write_grib2(path, fields)
