"""Core containers: formats, clip, plane geometry, field utilities."""
