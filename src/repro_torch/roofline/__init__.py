"""Roofline models of the port (counterpart of ``repro/roofline``)."""
