"""Calibration and proof tools of the benchmark, run on the card by hand."""
