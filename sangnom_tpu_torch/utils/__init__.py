"""Observability: dispatch logging and profiler scopes."""
