"""Input aggregation: raw events -> per-frame state -> PlayerInput.

The reference's ``InputState`` (clientdesktop/src/input.rs:10-101): sets of
*pressed* (edge) and *down* (held) keys, mouse buttons, accumulated cursor
and scroll deltas, cleared each frame. Embedders feed whatever event source
they have (terminal, notebook widget, test script); ``to_player_input``
applies the reference's default bindings (WASD/space/shift/ctrl/F).

A copy of ``voxelraytracing_tpu/engine/input.py`` (host code) over the
port's ``client``.
"""

from dataclasses import dataclass, field

from ..client.player import PlayerInput


@dataclass
class InputState:
    pressed_keys: set = field(default_factory=set)  # edges this frame
    down_keys: set = field(default_factory=set)  # currently held
    pressed_buttons: set = field(default_factory=set)
    down_buttons: set = field(default_factory=set)
    cursor_delta: tuple = (0.0, 0.0)
    scroll_delta: float = 0.0

    # ------------------------------------------------------------ events

    def key_down(self, key):
        key = key.lower()
        if key not in self.down_keys:
            self.pressed_keys.add(key)
        self.down_keys.add(key)

    def key_up(self, key):
        self.down_keys.discard(key.lower())

    def button_down(self, button):
        if button not in self.down_buttons:
            self.pressed_buttons.add(button)
        self.down_buttons.add(button)

    def button_up(self, button):
        self.down_buttons.discard(button)

    def move_cursor(self, dx, dy):
        self.cursor_delta = (self.cursor_delta[0] + dx, self.cursor_delta[1] + dy)

    def scroll(self, amount):
        self.scroll_delta += amount

    # ------------------------------------------------------------ queries

    def key_pressed(self, key):
        return key.lower() in self.pressed_keys

    def key_down_now(self, key):
        return key.lower() in self.down_keys

    def button_pressed(self, button):
        return button in self.pressed_buttons

    def finish_frame(self):
        """Clear per-frame edges/deltas (input.rs:88-100)."""
        self.pressed_keys.clear()
        self.pressed_buttons.clear()
        self.cursor_delta = (0.0, 0.0)
        self.scroll_delta = 0.0

    # ------------------------------------------------------------ bindings

    def to_player_input(self):
        """Default key bindings -> PlayerInput (main.rs update_input)."""
        return PlayerInput(
            cursor_movement=self.cursor_delta,
            forward=self.key_down_now("w"),
            backward=self.key_down_now("s"),
            left=self.key_down_now("a"),
            right=self.key_down_now("d"),
            jump=self.key_down_now("space"),
            crouch=self.key_down_now("shift"),
            sprint=self.key_down_now("ctrl"),
            toggle_fly=self.key_pressed("f"),
        )
