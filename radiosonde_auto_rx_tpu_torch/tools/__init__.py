"""Analysis / regression tools."""

import os


def repo_root() -> str:
    """Repository root (the directory holding ``tests/``), derived from
    this file — cwd-independent (tools/<file> is 2 levels below)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
