"""Synthetic LM data (the port's own numpy copy of ``repro/data``)."""
