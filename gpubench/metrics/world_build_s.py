"""The program's world builder: ``set_chunks`` of the whole window in the
engine's 512-chunk installs, then ``grid()`` and ``prepared()`` (the
harness's span around the set-up)."""


def read(ctx):
    return ctx.spans.get("world_build_s")
