"""Logging setup — the `log` + `env_logger` analog.

The reference wires the ``log`` crate through ``env_logger`` (re-exported
at common/src/lib.rs:11-12, initialized at clientdesktop/src/main.rs:41 and
servercli/src/main.rs:226) and controls verbosity with ``RUST_LOG``. Here
the stdlib ``logging`` module plays that role and ``VOXELTPU_LOG`` is the
environment knob (e.g. ``VOXELTPU_LOG=debug``); default level is WARNING,
so libraries stay quiet unless asked.

Port of ``voxelraytracing_tpu/utils/log.py``; the port's loggers live
under ``voxelraytracing_tpu_torch``.

Usage::

    from voxelraytracing_tpu_torch.utils.log import get_logger
    log = get_logger(__name__)
    log.info("client %s connected", name)

``init_logging()`` is idempotent and called lazily by ``get_logger``; CLI
entry points may call it eagerly to honor the env var before first use.
"""

import logging
import os

_LEVELS = {
    "trace": logging.DEBUG,  # no TRACE in stdlib; map down
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL + 10,
}

_ROOT = "voxelraytracing_tpu_torch"
_initialized = False


def init_logging(level=None):
    """Configure the package root logger once (env_logger::init analog)."""
    global _initialized
    root = logging.getLogger(_ROOT)
    if _initialized and level is None:
        return root
    if level is None:
        level = os.environ.get("VOXELTPU_LOG", "warning")
    lvl = _LEVELS.get(str(level).lower())
    if lvl is None:
        try:
            lvl = int(level)
        except (TypeError, ValueError):
            lvl = logging.WARNING
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter(
                "[%(asctime)s %(levelname)s %(name)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        root.addHandler(h)
        root.propagate = False
    root.setLevel(lvl)
    _initialized = True
    return root


def get_logger(name):
    """Module logger under the package root; initializes lazily."""
    init_logging()
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
