"""Offline tools: the DWD-ICON NetCDF -> .ic converter (convert_icon)."""
