"""``@log_decorator``: log a function's args, duration, return, and errors.

Port of ``dynode_tpu/utils/log_decorator.py``.
"""

import functools
import os
import time

from .log import logger


def log_decorator(func=None, *, level=None):
    """Wrap ``func`` to log entry (args/kwargs), wall time, result, exceptions.

    Records carry ``func_name_override``/``file_name_override`` extras so
    :class:`CustomLogFormatter` attributes them to the wrapped function
    rather than this wrapper.
    """

    def decorate(f):
        extras = {
            "func_name_override": f.__name__,
            "file_name_override": os.path.basename(f.__code__.co_filename),
        }

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            arg_repr = ", ".join(
                [repr(a) for a in args]
                + [f"{k}={v!r}" for k, v in kwargs.items()]
            )
            logger.info("Arguments: %s - Begin function" % arg_repr, extra=extras)
            start = time.perf_counter()
            try:
                result = f(*args, **kwargs)
            except Exception:
                logger.error(
                    "Exception: %s" % str(sys_exc_info_safe()), extra=extras
                )
                raise
            elapsed = time.perf_counter() - start
            logger.info(
                "Execution Time: %.6f seconds" % elapsed, extra=extras
            )
            logger.info("Returned: - End function %r" % (result,), extra=extras)
            return result

        return wrapper

    if func is not None:
        return decorate(func)
    return decorate


def sys_exc_info_safe() -> str:
    """Short description of the in-flight exception, if any."""
    import sys

    exc = sys.exc_info()[1]
    return repr(exc) if exc is not None else "<unknown>"


__all__ = ["log_decorator"]
