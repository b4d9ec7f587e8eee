"""Utilities of the port: logging, profiling, the board renderers and the
game viewer."""

from .logging import Logs, print_progress
