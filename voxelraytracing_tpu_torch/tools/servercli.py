"""Dedicated world server with a stdin CLI.

The servercli equivalent (servercli/src/main.rs:225-377): loads a world's
meta + datapack, builds the worldgen pipeline, serves TCP clients in a tick
loop with region-file persistence, and accepts console commands:

  stop                     save and shut down
  players                  list connected players
  world                    chunk/node occupancy stats
  tp <hex-id> <x> <y> <z>  teleport a player

Usage:
  python -m voxelraytracing_tpu_torch.tools.servercli <resource_root> <world_name> [port] [device]

``resource_root`` is a resource tree (datapacks/stylepacks/worlds) — e.g.
the bundled ``respack/``. Worldgen and the chunk SVO builds run on the
card; a ``device`` argument or ``VOXELTPU_DEVICE=cpu`` (or ``cuda:1``,
...) picks another torch device.

Port of ``voxelraytracing_tpu/tools/servercli.py``.
"""

import os
import queue
import sys
import threading
import time

# the environment knob that selects the server's torch device
DEVICE_ENV = "VOXELTPU_DEVICE"


def server_device(device=None):
    """The server's torch device: ``device``, else the environment knob
    ``VOXELTPU_DEVICE`` (``cpu``, ``cuda``, ``cuda:1``, ...), else the
    card."""
    return device or os.environ.get(DEVICE_ENV) or "cuda"


def run_server(resource_root, world_name, port=60000, host="127.0.0.1",
               tick_sleep=0.001, max_ticks=None, quiet=False, on_ready=None,
               cli=True, device=None):
    """Serve ``world_name`` of ``resource_root`` until ``stop`` (or
    ``max_ticks``); worldgen and the SVO builds run on
    :func:`server_device` of ``device``."""
    from ..resources.packs import Resources
    from ..server import ServerState, ServerWorld, WorldFs
    from ..worldgen import WorldGen

    res = Resources.load_from(resource_root)
    world_meta = next(w for w in res.worlds if w.name == world_name)
    pack = res.datapacks[world_meta.datapack]
    gen = WorldGen.from_datapack(pack, seed=world_meta.seed,
                                 device=server_device(device))

    world_dir = os.path.join(resource_root, "worlds", _world_dir_name(resource_root, world_name))
    fs = WorldFs(world_dir)

    world = ServerWorld(gen)
    state = ServerState(world, voxel_pack=pack.voxels, host=host, port=port)
    actual_port = state.start()
    if not quiet:
        print(f"serving '{world_name}' on {host}:{actual_port}", flush=True)
    if on_ready is not None:
        on_ready(state, actual_port)

    cmds = queue.Queue()
    if cli:
        threading.Thread(target=_stdin_loop, args=(cmds,), daemon=True).start()

    ticks = 0
    try:
        while True:
            state.handle_clients()
            state.update(fs=fs)
            state.update_world()
            try:
                line = cmds.get_nowait()
            except queue.Empty:
                line = None
            if line is not None and _handle_cli(line, state, world, fs, quiet):
                break
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
            time.sleep(tick_sleep)
    finally:
        saved = fs.save(world)
        if not quiet:
            print(f"saved {saved} chunks", flush=True)
        state.stop()
    return state


def _world_dir_name(resource_root, world_name):
    base = os.path.join(resource_root, "worlds")
    for entry in sorted(os.listdir(base)):
        meta = os.path.join(base, entry, "meta.ron")
        if os.path.isfile(meta):
            from ..resources.packs import parse_world_meta

            with open(meta, "r", encoding="utf-8") as f:
                if parse_world_meta(f.read()).name == world_name:
                    return entry
    raise FileNotFoundError(world_name)


def _stdin_loop(out_queue):
    try:
        for line in sys.stdin:
            out_queue.put(line.strip())
    except (OSError, ValueError):
        # stdin unreadable (closed, or a captured test stream) — the CLI
        # simply goes quiet; the tick loop runs on.
        pass


def _handle_cli(line, state, world, fs, quiet):
    """Console commands (servercli/src/main.rs:333-377). Returns True on stop."""
    parts = line.split()
    if not parts:
        return False
    cmd = parts[0]
    if cmd == "stop":
        return True
    if cmd == "players":
        for c in state.clients.values():
            print(f"  {c.id:016x} {c.name} @ {c.pos}", flush=True)
        print(f"{len(state.clients)} player(s)", flush=True)
    elif cmd == "world":
        n_chunks = len(world.chunks)
        cached = sum(1 for c in world.chunks.values() if c.nodes is not None)
        used_nodes = sum(
            len(c.nodes) for c in world.chunks.values() if c.nodes is not None
        )
        print(
            f"{n_chunks} chunks loaded; {cached} with built SVO "
            f"({used_nodes} nodes); {fs.dirty_count()} dirty; "
            f"{len(world.unplaced_features)} features pending",
            flush=True,
        )
    elif cmd == "tp" and len(parts) == 5:
        cid = int(parts[1], 16)
        pos = tuple(float(v) for v in parts[2:5])
        state.teleport(cid, pos)
    elif not quiet:
        print(f"unknown command: {line!r}", flush=True)
    return False


def main():
    from ..utils.log import init_logging

    init_logging()  # honor VOXELTPU_LOG (env_logger::init analog)
    if len(sys.argv) < 3:
        print(__doc__)
        return 1
    root, world_name = sys.argv[1], sys.argv[2]
    port = int(sys.argv[3]) if len(sys.argv) > 3 else 60000
    device = sys.argv[4] if len(sys.argv) > 4 else None
    run_server(root, world_name, port=port, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
