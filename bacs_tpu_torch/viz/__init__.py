"""Visualisation helpers."""
