"""Roofline and step statistics of the dry run (counterpart of
``repro.analysis``)."""
