"""Interactive terminal client.

Port of ``voxelraytracing_tpu/tools/client_cli.py``. The desktop-shell
stand-in for a windowless host: drives the full
engine stack — UI page stack, singleplayer hosting or joining, the frame
loop, movement/look, voxel editing — from a line-based REPL, writing frames
to PNG files instead of a swapchain.

Usage:
  python -m voxelraytracing_tpu_torch.tools.client_cli [resource_root] [--device cpu]

Commands (in game):
  w/a/s/d [n]      move n ticks (default 10)        look <pitch> <yaw>
  jump | fly       movement                          break | place [voxel]
  frame [path]     render to PNG (default frame.png; frame.png.npy
                   without PIL)
  heatmap          toggle step-count heatmap         overlay
  size <n>         resize world window               pause | quit
"""

import os
import shlex
import sys

import numpy as np


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    from ..utils.log import init_logging

    init_logging()  # honor VOXELTPU_LOG (env_logger::init analog)
    from ..engine import EngineApp
    from ..engine.input import InputState
    from ..engine.ui import Page, UiState
    from ..resources.packs import Resources, builtin_respack_path

    root = argv[0] if argv else builtin_respack_path()
    ui = UiState(resources=Resources.load_from(root))
    inp = InputState()
    app = None

    print("voxelraytracing_tpu_torch client — 'help' for commands", flush=True)
    while True:
        view = ui.view()
        prompt = f"[{view['page']}]> "
        try:
            line = input(prompt)
        except EOFError:
            break
        args = shlex.split(line)
        if not args:
            continue
        cmd, rest = args[0], args[1:]

        if cmd in ("quit", "exit"):
            break
        if cmd == "help":
            print(__doc__, flush=True)
            continue

        if view["page"] == Page.TITLE:
            if cmd == "my_worlds":
                ui.push(Page.MY_WORLDS)
            elif cmd == "join_world":
                ui.push(Page.JOIN_WORLD)
            elif cmd == "options":
                ui.push(Page.OPTIONS)
        elif view["page"] == Page.MY_WORLDS:
            if cmd == "play" and rest:
                name = " ".join(rest)
                app = EngineApp.host_singleplayer(
                    root, name, world_size_chunks=ui.world_size_chunks,
                    device=device,
                )
                ui.reset_to(Page.IN_GAME)
                print(f"playing '{name}'", flush=True)
            elif cmd == "create" and rest:
                path = ui.create_world(" ".join(rest))
                print(f"created {path}", flush=True)
            elif cmd == "back":
                ui.pop()
            else:
                print("worlds:", ", ".join(w.name for w in ui.worlds()), flush=True)
        elif view["page"] == Page.JOIN_WORLD:
            if cmd == "join":
                addr = rest[0] if rest else ui.join_addr
                host, port = addr.rsplit(":", 1)
                try:
                    app = EngineApp.join(
                        (host, int(port)), "terminal-player",
                        resource_root=root, device=device,
                    )
                    ui.reset_to(Page.IN_GAME)
                except Exception as e:  # HandshakeDenied / refused
                    ui.join_error = str(e)
                    print(f"join failed: {e}", flush=True)
            elif cmd == "back":
                ui.pop()
        elif view["page"] in (Page.OPTIONS, Page.VISUALS, Page.CONTROLS):
            if cmd == "back":
                ui.pop()
            elif cmd in ("visuals", "controls"):
                ui.push(cmd)
        elif view["page"] == Page.PAUSE:
            if cmd == "resume":
                ui.reset_to(Page.IN_GAME)
            elif cmd == "leave":
                app.close()
                app = None
                ui.reset_to(Page.TITLE)
            elif cmd == "options":
                ui.push(Page.OPTIONS)
        elif view["page"] == Page.IN_GAME and app is not None:
            _game_cmd(app, ui, inp, cmd, rest)

    if app is not None:
        app.close()
    return 0


def _game_cmd(app, ui, inp, cmd, rest):
    from ..engine.ui import Page
    from ..models.raytracer import to_srgb8

    def ticks(default=10):
        return int(rest[0]) if rest else default

    if cmd in ("w", "a", "s", "d"):
        for _ in range(ticks()):
            inp.key_down(cmd)
            app.update(net_budget_s=0.02)
            app.update_input(inp.to_player_input())
            inp.key_up(cmd)
            inp.finish_frame()
            app.update_game()
    elif cmd == "jump":
        inp.key_down("space")
        app.update_input(inp.to_player_input())
        inp.key_up("space")
        inp.finish_frame()
    elif cmd == "fly":
        inp.key_down("f")
        app.update_input(inp.to_player_input())
        inp.key_up("f")
        inp.finish_frame()
    elif cmd == "look" and len(rest) >= 2:
        app.game.player.rot = np.asarray(
            [float(rest[0]), float(rest[1]), 0.0], np.float32
        )
    elif cmd == "break":
        print("broke" if app.break_voxel() else "nothing in reach", flush=True)
    elif cmd == "place":
        if rest:
            app.placing_voxel = app.game.voxels.by_name(rest[0])
        print("placed" if app.place_voxel() else "nothing in reach", flush=True)
    elif cmd == "frame":
        path = rest[0] if rest else "frame.png"
        app.update(net_budget_s=0.1)
        app.update_game()
        img = app.draw_frame()
        try:
            from PIL import Image

            Image.fromarray(to_srgb8(img)).save(path)
            print(f"wrote {path}", flush=True)
        except ImportError:
            np.save(path + ".npy", img.cpu().numpy())
            print(f"wrote {path}.npy (PIL unavailable)", flush=True)
    elif cmd == "heatmap":
        app.toggle_step_heatmap()
    elif cmd == "overlay":
        for k, v in ui.game_overlay(app).items():
            print(f"  {k}: {v}", flush=True)
    elif cmd == "size" and rest:
        ui.world_size_chunks = int(rest[0])
        app.resize_world(ui.world_size_chunks)
    elif cmd == "pause":
        ui.push(Page.PAUSE)
    else:
        print(f"unknown command {cmd!r}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
