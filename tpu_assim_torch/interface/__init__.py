"""Interface helpers (port of :mod:`tpu_assim.interface`; the class API is
not ported yet)."""
