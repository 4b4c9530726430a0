"""The demos' command line."""
from __future__ import annotations

import argparse


def parse(description: str, argv=None, **extra) -> argparse.Namespace:
    """``--device`` (the card when omitted) and ``--show``, plus ``extra``
    options given as ``name=(type, default)``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--show", action="store_true", help="open an interactive render")
    for name, (typ, default) in extra.items():
        ap.add_argument(f"--{name}", type=typ, default=default)
    return ap.parse_args(argv)
