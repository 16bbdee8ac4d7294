"""Decoder model building blocks."""
