"""Helpers of the port's engine and tool tests: a resource tree whose demo
world is "Flat" (terra, seed 7, as tests/test_engine_app.py writes it) and
the port's server for it ticking in a thread of the test process, with its
worldgen on the CPU."""

import os
import shutil
import threading
import time

from voxelraytracing_tpu_torch.resources.packs import (
    Resources, builtin_respack_path)

FLAT_META = ('(name: "Flat", version: (0, 1), datapack: "terra", '
             'stylepack: "terra", seed: 7,)')


def flat_root(base):
    """Copy the bundled resource pack to ``base``/res with the demo world
    renamed "Flat"; returns the root."""
    root = os.path.join(str(base), "res")
    shutil.copytree(builtin_respack_path(), root)
    with open(os.path.join(root, "worlds", "demo", "meta.ron"), "w") as f:
        f.write(FLAT_META)
    return root


class ServedWorld:
    """The port's ``ServerState`` serving a world of ``root`` on a free
    localhost port, ticked by a thread; :meth:`stop` joins it and
    re-raises what the thread raised."""

    def __init__(self, root, world_name="Flat"):
        from voxelraytracing_tpu_torch.server import ServerState, ServerWorld
        from voxelraytracing_tpu_torch.worldgen import WorldGen

        res = Resources.load_from(root)
        meta = next(w for w in res.worlds if w.name == world_name)
        pack = res.datapacks[meta.datapack]
        gen = WorldGen.from_datapack(pack, seed=meta.seed, device="cpu")
        self.state = ServerState(ServerWorld(gen), voxel_pack=pack.voxels)
        self.port = self.state.start()
        self.error = None
        self.halt = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while not self.halt.is_set():
                self.state.handle_clients()
                self.state.update()
                self.state.update_world()
                time.sleep(0.001)
        except BaseException as e:  # handed to the test by stop()
            self.error = e

    def stop(self):
        self.halt.set()
        self.thread.join()
        self.state.stop()
        if self.error is not None:
            raise self.error


def stream_window(app, n=64, limit_s=120.0):
    """Pump ``app`` until its window holds ``n`` chunks."""
    t0 = time.monotonic()
    while app.game.world.populated_count() < n:
        assert time.monotonic() - t0 < limit_s, "the window did not stream"
        app.update(net_budget_s=0.05)
        app.update_game()
    return app.game.world.populated_count()
