"""Chunked rendering and image evaluation (reference renderer.py)."""
