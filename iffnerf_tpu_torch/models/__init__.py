"""Radiance-field inference: field features, shading heads, rendering."""
