"""UI page-stack state machine (headless).

The reference's egui UI (clientdesktop/src/ui.rs:31-512) is a page stack:
title screen -> my-worlds / join-world / options (visuals, controls) ->
in-game pause menu, plus the in-game overlay. With no windowing system on a
headless host, the same navigation/state logic lives here as a data-driven state
machine — front-ends (terminal client, notebook, web) render `view()` and
feed `actions`. World management (list/create/play) operates on the
resource tree exactly like the reference's MyWorlds page.

A copy of ``voxelraytracing_tpu/engine/ui.py`` (host code).
"""

import os
from dataclasses import dataclass, field


class Page:
    TITLE = "title"
    MY_WORLDS = "my_worlds"
    JOIN_WORLD = "join_world"
    OPTIONS = "options"
    VISUALS = "visuals"
    CONTROLS = "controls"
    IN_GAME = "in_game"
    PAUSE = "pause"


@dataclass
class CrosshairStyle:
    """Visuals page: crosshair editor (ui.rs Options/Visuals)."""

    style: str = "cross"  # "dot" | "cross"
    size: float = 8.0
    color: tuple = (1.0, 1.0, 1.0, 0.8)


@dataclass
class UiState:
    resources: object = None  # resources.packs.Resources
    page_stack: list = field(default_factory=lambda: [Page.TITLE])
    join_addr: str = "127.0.0.1:60000"
    join_error: str = ""
    new_world_name: str = ""
    crosshair: CrosshairStyle = field(default_factory=CrosshairStyle)
    world_size_chunks: int = 30  # 10..80 slider (ui.rs:163-168)

    # ------------------------------------------------------------ stack

    @property
    def page(self):
        return self.page_stack[-1]

    def push(self, page):
        self.page_stack.append(page)

    def pop(self):
        if len(self.page_stack) > 1:
            self.page_stack.pop()

    def reset_to(self, page):
        self.page_stack = [page]

    # ------------------------------------------------------------ worlds

    def worlds(self):
        return list(self.resources.worlds) if self.resources else []

    def create_world(self, name, datapack="terra", stylepack="terra", seed=0):
        """Write a new world folder + meta.ron (MyWorlds 'create')."""
        base = os.path.join(self.resources.path, "worlds")
        folder = name.lower().replace(" ", "_") or "world"
        path = os.path.join(base, folder)
        n = 1
        while os.path.exists(path):
            n += 1
            path = os.path.join(base, f"{folder}_{n}")
        os.makedirs(path)
        with open(os.path.join(path, "meta.ron"), "w", encoding="utf-8") as f:
            f.write(
                f'(\n    name: "{name}",\n    version: (0, 1),\n'
                f'    datapack: "{datapack}",\n    stylepack: "{stylepack}",\n'
                f"    seed: {int(seed)},\n)\n"
            )
        self.resources.reload_worlds()
        return path

    # ------------------------------------------------------------ views

    def view(self):
        """Current page as renderable data (labels + available actions)."""
        p = self.page
        if p == Page.TITLE:
            return {
                "page": p,
                "actions": ["my_worlds", "join_world", "options", "quit"],
            }
        if p == Page.MY_WORLDS:
            return {
                "page": p,
                "worlds": [w.name for w in self.worlds()],
                "actions": ["play", "create", "back"],
            }
        if p == Page.JOIN_WORLD:
            return {
                "page": p,
                "addr": self.join_addr,
                "error": self.join_error,
                "actions": ["join", "back"],
            }
        if p == Page.OPTIONS:
            return {"page": p, "actions": ["visuals", "controls", "back"]}
        if p == Page.VISUALS:
            return {"page": p, "crosshair": self.crosshair, "actions": ["back"]}
        if p == Page.CONTROLS:
            return {"page": p, "actions": ["back"]}
        if p == Page.PAUSE:
            return {
                "page": p,
                "actions": ["resume", "options", "leave"],
            }
        return {"page": p, "actions": ["pause"]}

    def game_overlay(self, app):
        """In-game overlay data (ui.rs:105-178) + live world-size slider."""
        data = app.debug_overlay()
        data["crosshair"] = self.crosshair
        return data
