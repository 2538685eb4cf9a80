"""Bucketed frame batching for the serving path."""
