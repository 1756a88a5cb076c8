"""One-line CLI error reporting for user mistakes (bad paths, bad option values)
instead of full tracebacks; unexpected exceptions still propagate with traceback
(a copy of `salsa_tpu.cli._errors`)."""
from __future__ import annotations

import functools
import sys

USER_ERRORS = (FileNotFoundError, NotADirectoryError, ValueError, AssertionError)


def cli_entry(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except USER_ERRORS as e:
            print(f"error: {e}", file=sys.stderr)
            sys.exit(2)

    return wrapper
