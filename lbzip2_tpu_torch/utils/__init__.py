"""Utilities: tracing/observability."""
