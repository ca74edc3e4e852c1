"""Synthetic data substrate (numpy only)."""
