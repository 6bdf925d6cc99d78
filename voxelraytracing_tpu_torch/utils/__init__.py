"""Logging of the port (``utils/log.py``)."""
