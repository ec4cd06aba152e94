"""Deterministic token sources and the training data pipeline."""
