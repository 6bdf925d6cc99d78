"""The program's frame entries the windows drive, one file each, found by
the name a traffic mix gives. Each has ``setup(world, cfg, frames,
device)`` (the program's own set-up: its tables from the world's chunks),
``frame(state, cam, key)`` (one call of the entry, returning the frame it
made), ``REFERENCE`` (the reference frame it is compared with) and, for a
path tracer, ``DRAWS`` (how its draws follow from the key)."""
