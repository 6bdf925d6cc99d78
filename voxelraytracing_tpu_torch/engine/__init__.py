"""Interactive engine: the headless app-shell (frame loop, picking, hosting)."""

from .app import EngineApp, ServerProgram, Timers

__all__ = ["EngineApp", "ServerProgram", "Timers"]
