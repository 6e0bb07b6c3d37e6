"""Synthetic graph datasets (numpy host code)."""
