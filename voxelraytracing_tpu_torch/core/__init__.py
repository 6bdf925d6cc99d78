"""Core formats and host geometry of the port: SVO nodes and spec,
coords, math, the native library, world-format constants."""
