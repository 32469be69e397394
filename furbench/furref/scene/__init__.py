"""Frozen plain reference of the path tracer (see furbench/README.md)."""
