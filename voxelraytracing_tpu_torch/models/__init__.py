"""User-facing renderers of the port."""
