"""Grid arithmetic and image metrics (reference utils.py)."""
