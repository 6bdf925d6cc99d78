"""User-facing model families: renderers and their settings."""

from .pathtracer import PathTracer, accumulate
from .raytracer import (
    RayTracer,
    RenderSettings,
    WavefrontRenderer,
    composite_crosshair,
    shade_hits,
    to_srgb8,
)

__all__ = [
    "PathTracer",
    "RayTracer",
    "RenderSettings",
    "WavefrontRenderer",
    "accumulate",
    "composite_crosshair",
    "shade_hits",
    "to_srgb8",
]
