"""Logging, metrics and statistics helpers."""
