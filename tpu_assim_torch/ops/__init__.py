"""Analysis cores (port of :mod:`tpu_assim.ops`)."""
