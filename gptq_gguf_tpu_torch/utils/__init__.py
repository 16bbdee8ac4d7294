"""Calibration data loading."""
