"""Device compute of the port: camera, tables, the v4 march."""
