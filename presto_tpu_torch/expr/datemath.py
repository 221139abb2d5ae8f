"""Calendar arithmetic as branch-free integer ops.

The reference leans on Joda-style date libraries for EXTRACT/date_add
(presto-main/.../operator/scalar/DateTimeFunctions.java).  On TPU, calendar
math must be vectorizable pure arithmetic, so this module implements the
standard days<->civil conversion (Howard Hinnant's public-domain "civil"
algorithms) over whole arrays, usable with numpy or torch tensors (the
``xp`` namespace of expr/xp.py).  Booleans never enter the arithmetic:
torch refuses bool subtraction, so month carries go through ``where``.  All inputs/outputs are days since 1970-01-01.
"""

from __future__ import annotations


def civil_from_days(xp, z):
    """days-since-epoch -> (year, month, day), elementwise."""
    z = z + 719468
    era = xp.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + xp.where(mp < 10, 3, -9)
    y = y + xp.where(m <= 2, 1, 0)
    return y, m, d


def days_from_civil(xp, y, m, d):
    """(year, month, day) -> days-since-epoch, elementwise."""
    y = y - xp.where(m <= 2, 1, 0)
    era = xp.floor_divide(y, 400)
    yoe = y - era * 400
    mp = xp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def days_in_month(xp, y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    feb = xp.where(leap, 29, 28)
    lengths = xp.where(
        (m == 4) | (m == 6) | (m == 9) | (m == 11), 30,
        xp.where(m == 2, feb, 31))
    return lengths


def add_months(xp, days, months):
    """date + INTERVAL MONTH with end-of-month clamping (SQL semantics)."""
    y, m, d = civil_from_days(xp, days)
    m0 = m - 1 + months
    y2 = y + xp.floor_divide(m0, 12)
    m2 = xp.mod(m0, 12) + 1
    d2 = xp.minimum(d, days_in_month(xp, y2, m2))
    return days_from_civil(xp, y2, m2, d2)


def extract_field(xp, days, field: str):
    y, m, d = civil_from_days(xp, days)
    if field == "year":
        return y
    if field == "month":
        return m
    if field == "day":
        return d
    if field == "quarter":
        return (m - 1) // 3 + 1
    if field == "week":
        # ISO week number
        doy_ord = days - days_from_civil(xp, y, xp.ones_like(m), xp.ones_like(d)) + 1
        dow = xp.mod(days + 3, 7) + 1  # 1=Mon..7=Sun (1970-01-01 was Thu)
        week = (doy_ord - dow + 10) // 7
        # weeks 0 / 53 wrap into neighbor years; approximation good enough
        return xp.clip(week, 1, 53)
    if field == "day_of_week" or field == "dow":
        return xp.mod(days + 3, 7) + 1
    if field == "day_of_year" or field == "doy":
        return days - days_from_civil(xp, y, xp.ones_like(m), xp.ones_like(d)) + 1
    raise ValueError(f"unsupported extract field: {field}")
