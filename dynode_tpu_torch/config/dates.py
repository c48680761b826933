"""Process-level simulation init-date flag and sim-day arithmetic.

Port of ``dynode_tpu/config/dates.py`` (plain Python, unchanged). The flag is stored in
a PID-keyed environment variable so concurrent runs in one interpreter tree
don't clobber each other; ``simulation_day(y, m, d)`` converts calendar dates
inside configs to (possibly negative) integer sim-days.
"""

import datetime
import os
from datetime import date
from typing import Optional


def _env_key() -> str:
    return f"DYNODE_INITIALIZATION_DATE({os.getpid()})"


def get_dynode_init_date_flag() -> Optional[datetime.date]:
    """Read this process's init date, or None if unset."""
    raw = os.getenv(_env_key(), None)
    if raw is None:
        return None
    return datetime.datetime.strptime(raw, "%Y-%m-%d").date()


def set_dynode_init_date_flag(init_date: datetime.date) -> None:
    """Set this process's init date (consumed by :func:`simulation_day`)."""
    os.environ[_env_key()] = init_date.strftime("%Y-%m-%d")


def simulation_day(year: int, month: int, day: int) -> int:
    """Days from the process init date to date(year, month, day); may be negative.

    Raises
    ------
    ValueError
        if :func:`set_dynode_init_date_flag` was never called in this process.
    """
    init_date = get_dynode_init_date_flag()
    if init_date is None:
        raise ValueError(
            "attempting to use SimulationDate helper method without first "
            "calling set_dynode_init_date_flag() to set env flag."
        )
    return (date(year, month, day) - init_date).days


__all__ = [
    "get_dynode_init_date_flag",
    "set_dynode_init_date_flag",
    "simulation_day",
]
