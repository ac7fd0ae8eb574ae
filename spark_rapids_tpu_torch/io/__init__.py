"""Parquet input: still-encoded column chunks and footer pruning."""
