"""Log formatter honoring func/file name overrides from the log decorator.

Port of ``dynode_tpu/utils/custom_log_formatter.py``.
"""

import logging


class CustomLogFormatter(logging.Formatter):
    """Formatter that respects ``func_name_override``/``file_name_override``.

    ``log_decorator`` wraps functions, so the stdlib would report the
    wrapper's name/file; the decorator attaches overrides to each record and
    this formatter swaps them in before formatting.
    """

    def format(self, record: logging.LogRecord) -> str:
        """Format ``record``, honoring the decorator's name/file overrides."""
        if hasattr(record, "func_name_override"):
            record.funcName = record.func_name_override
        if hasattr(record, "file_name_override"):
            record.filename = record.file_name_override
        return super().format(record)


__all__ = ["CustomLogFormatter"]
