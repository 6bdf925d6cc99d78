"""Installer: set up the user's resource tree.

The reference installer copies the bundled resource pack into
``$CONFIG/blockworld/`` without overwriting user edits and installs the
server binary (installer/src/main.rs:14-45). Here: copy ``respack/`` into a
config directory (default ``~/.config/voxelraytracing_tpu``, the JAX
package's, so both packages share one resource tree) — the "server
binary" is just this package, so nothing else to build.

Usage: python -m voxelraytracing_tpu_torch.tools.installer [dest_dir]

A copy of ``voxelraytracing_tpu/tools/installer.py`` over the port's
``resources``.
"""

import os
import shutil
import sys


def default_config_dir():
    base = os.environ.get(
        "XDG_CONFIG_HOME", os.path.join(os.path.expanduser("~"), ".config")
    )
    return os.path.join(base, "voxelraytracing_tpu")


def install(dest=None, overwrite=False):
    from ..resources.packs import builtin_respack_path

    src = builtin_respack_path()
    dest = dest or default_config_dir()
    installed = []
    for sub in ("datapacks", "stylepacks", "worlds"):
        sdir = os.path.join(src, sub)
        if not os.path.isdir(sdir):
            continue
        for pack in sorted(os.listdir(sdir)):
            s = os.path.join(sdir, pack)
            d = os.path.join(dest, sub, pack)
            if os.path.exists(d) and not overwrite:
                continue  # never clobber user edits (installer/src/main.rs:23-27)
            shutil.copytree(s, d, dirs_exist_ok=overwrite)
            installed.append(os.path.join(sub, pack))
    return dest, installed


def main():
    dest = sys.argv[1] if len(sys.argv) > 1 else None
    dest, installed = install(dest)
    for p in installed:
        print(f"installed {p}")
    print(f"resource root: {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
