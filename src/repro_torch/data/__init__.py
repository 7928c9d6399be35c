"""Synthetic token data (numpy)."""
