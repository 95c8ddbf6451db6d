"""Entry points: the serving loop and its step functions."""
