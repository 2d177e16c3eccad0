"""Metrics, serialization, and misc host utilities."""
