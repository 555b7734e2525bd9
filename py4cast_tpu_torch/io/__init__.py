"""Inference product export: the GRIB2 codec (``grib2``) and the GIF and
GRIB writers over it (``outputs``)."""
