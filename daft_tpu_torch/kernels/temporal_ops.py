"""Temporal kernels (port of ``daft_tpu/kernels/temporal_ops.py``; reference:
src/daft-functions-temporal).

Arrow compute on the host, as in the JAX package. The time-zone kernels need
the system's tz database (``zoneinfo`` and Arrow's own lookup): a missing zone
raises. ``today`` and ``now`` read the per-query clock (``context.query_now``),
so every morsel of one statement sees the same instant.
"""

from __future__ import annotations

import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType, TimeUnit, TypeId
from daft_tpu_torch.kernels.registry import register_kernel, returns
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

_I32 = DataType.int32()
_U32 = DataType.uint32()


def _wrap(out, name, dtype):
    return Series.from_arrow(out, name, dtype)


def _simple(name, pc_fn, dtype, cast=None):
    @register_kernel(name, returns(dtype))
    def fn(args, **kwargs):
        out = pc_fn(args[0].to_arrow())
        if cast is not None:
            out = out.cast(cast)
        return _wrap(out, args[0].name, dtype)

    return fn


_simple("dt_day", pc.day, _U32, pa.uint32())
_simple("dt_hour", pc.hour, _U32, pa.uint32())
_simple("dt_minute", pc.minute, _U32, pa.uint32())
_simple("dt_second", pc.second, _U32, pa.uint32())
_simple("dt_millisecond", pc.millisecond, _U32, pa.uint32())
_simple("dt_microsecond", pc.microsecond, _U32, pa.uint32())
_simple("dt_month", pc.month, _U32, pa.uint32())
_simple("dt_quarter", pc.quarter, _U32, pa.uint32())
_simple("dt_year", pc.year, _I32, pa.int32())
_simple("dt_day_of_year", pc.day_of_year, _U32, pa.uint32())
_simple("dt_week_of_year", pc.iso_week, _U32, pa.uint32())


@register_kernel("dt_date", returns(DataType.date()))
def _date(args, **kwargs):
    return _wrap(args[0].to_arrow().cast(pa.date32()), args[0].name, DataType.date())


@register_kernel("dt_day_of_week", returns(_U32))
def _day_of_week(args, **kwargs):
    out = pc.day_of_week(args[0].to_arrow(), count_from_zero=True)
    return _wrap(out.cast(pa.uint32()), args[0].name, _U32)


@register_kernel("dt_time", lambda f, k: Field(f[0].name, DataType.time("us")))
def _time(args, **kwargs):
    out = args[0].to_arrow().cast(pa.time64("us"))
    return _wrap(out, args[0].name, DataType.time("us"))


@register_kernel("dt_truncate", lambda f, k: f[0])
def _truncate(args, interval: str = "1 day", **kwargs):
    num, unit = interval.split(" ", 1) if " " in interval else ("1", interval)
    unit = unit.rstrip("s")
    out = pc.floor_temporal(args[0].to_arrow(), multiple=int(num), unit=unit)
    return Series.from_arrow(out, args[0].name, args[0].dtype)


@register_kernel("dt_to_unix_epoch", returns(DataType.int64()))
def _to_unix_epoch(args, time_unit: str = "s", **kwargs):
    tu = TimeUnit.from_str(time_unit)
    arr = args[0].to_arrow()
    if not pa.types.is_timestamp(arr.type):
        arr = arr.cast(pa.timestamp("us"))
    out = arr.cast(pa.timestamp(tu.value)).cast(pa.int64())
    return _wrap(out, args[0].name, DataType.int64())


@register_kernel("dt_strftime", returns(DataType.string()))
def _strftime(args, format=None, **kwargs):
    fmt = format or ("%Y-%m-%d" if args[0].dtype.id == TypeId.DATE else "%Y-%m-%dT%H:%M:%S%.f")
    fmt = fmt.replace("%.f", "%f")
    out = pc.strftime(args[0].to_arrow(), format=fmt)
    return _wrap(out.cast(pa.large_string()), args[0].name, DataType.string())


@register_kernel("dt_total_seconds", returns(DataType.float64()))
def _total_seconds(args, **kwargs):
    arr = args[0].to_arrow()
    us = arr.cast(pa.duration("us")).cast(pa.int64())
    out = pc.divide(us.cast(pa.float64()), 1_000_000.0)
    return _wrap(out, args[0].name, DataType.float64())


# ------------------------------------------------------------------ #
# Date arithmetic long tail (reference: daft/functions/datetime.py)   #
# ------------------------------------------------------------------ #
@register_kernel("dt_nanosecond", returns(_U32))
def _nanosecond(args, **kwargs):
    arr = args[0].to_arrow()
    us = pc.microsecond(arr)
    return _wrap(pc.multiply(us.cast(pa.int64()), 1000).cast(pa.uint32()),
                 args[0].name, _U32)


def _total_factory(name, divisor_us):
    @register_kernel(name, returns(DataType.float64()))
    def _k(args, **kwargs):
        us = args[0].to_arrow().cast(pa.duration("us")).cast(pa.int64())
        out = pc.divide(us.cast(pa.float64()), float(divisor_us))
        return _wrap(out, args[0].name, DataType.float64())
    return _k


_total_factory("dt_total_milliseconds", 1_000)
_total_factory("dt_total_microseconds", 1)
_total_factory("dt_total_minutes", 60_000_000)
_total_factory("dt_total_hours", 3_600_000_000)
_total_factory("dt_total_days", 86_400_000_000)


@register_kernel("dt_total_nanoseconds", returns(DataType.int64()))
def _total_ns(args, **kwargs):
    us = args[0].to_arrow().cast(pa.duration("us")).cast(pa.int64())
    return _wrap(pc.multiply(us, 1000), args[0].name, DataType.int64())


@register_kernel("dt_unix_date", returns(DataType.int64()))
def _unix_date(args, **kwargs):
    out = args[0].to_arrow().cast(pa.date32()).cast(pa.int32()).cast(pa.int64())
    return _wrap(out, args[0].name, DataType.int64())


@register_kernel("date_from_unix_date", returns(DataType.date()))
def _date_from_unix_date(args, **kwargs):
    out = args[0].to_arrow().cast(pa.int32()).cast(pa.date32())
    return _wrap(out, args[0].name, DataType.date())


def _ts_factory(name, unit):
    @register_kernel(name, lambda f, k: Field(f[0].name, DataType.timestamp(unit)))
    def _k(args, **kwargs):
        out = args[0].to_arrow().cast(pa.int64()).cast(pa.timestamp(unit))
        return _wrap(out, args[0].name, DataType.timestamp(unit))
    return _k


_ts_factory("timestamp_seconds", "s")
_ts_factory("timestamp_millis", "ms")
_ts_factory("timestamp_micros", "us")


@register_kernel("date_add", lambda f, k: f[0])
def _date_add(args, days: int = 0, **kwargs):
    arr = args[0].to_arrow()
    if len(args) > 1:
        d = args[1].to_arrow().cast(pa.int64())
        if pa.types.is_date(arr.type):
            out = pc.add(arr.cast(pa.int32()).cast(pa.int64()), d).cast(pa.int32()).cast(pa.date32())
        else:
            out = pc.add(arr, pc.multiply(d, 86_400_000_000).cast(pa.duration("us")))
    else:
        if pa.types.is_date(arr.type):
            out = pc.add(arr.cast(pa.int32()), days).cast(pa.int32()).cast(pa.date32())
        else:
            out = pc.add(arr, pa.scalar(days * 86_400_000_000, pa.duration("us")))
    return _wrap(out, args[0].name, args[0].dtype)


@register_kernel("date_sub", lambda f, k: f[0])
def _date_sub(args, days: int = 0, **kwargs):
    from daft_tpu_torch.kernels.registry import get_kernel

    if len(args) > 1:
        neg = Series.from_arrow(pc.negate(args[1].to_arrow().cast(pa.int64())),
                                args[1].name, DataType.int64())
        return get_kernel("date_add")([args[0], neg])
    return get_kernel("date_add")([args[0]], days=-days)


@register_kernel("date_diff", returns(DataType.int64()))
def _date_diff(args, **kwargs):
    a = args[0].to_arrow().cast(pa.date32()).cast(pa.int32()).cast(pa.int64())
    b = args[1].to_arrow().cast(pa.date32()).cast(pa.int32()).cast(pa.int64())
    return _wrap(pc.subtract(a, b), args[0].name, DataType.int64())


@register_kernel("add_months", lambda f, k: f[0])
def _add_months(args, months: int = 1, **kwargs):
    import datetime as _dt

    def do(v):
        if v is None:
            return None
        d = v.date() if isinstance(v, _dt.datetime) else v
        total = d.year * 12 + (d.month - 1) + months
        y, m = divmod(total, 12)
        m += 1
        # clamp to month end
        for day in (d.day, 30, 29, 28):
            try:
                nd = _dt.date(y, m, day)
                break
            except ValueError:
                continue
        if isinstance(v, _dt.datetime):
            return _dt.datetime.combine(nd, v.time())
        return nd

    return Series.from_pylist([do(v) for v in args[0].to_pylist()],
                              args[0].name, args[0].dtype)


@register_kernel("months_between", returns(DataType.float64()))
def _months_between(args, **kwargs):
    import datetime as _dt

    a = args[0].to_pylist()
    b = args[1].to_pylist()
    if len(b) == 1 and len(a) != 1:
        b = b * len(a)

    def norm(v):
        return v.date() if isinstance(v, _dt.datetime) else v

    def do(x, y):
        if x is None or y is None:
            return None
        x, y = norm(x), norm(y)
        return (x.year - y.year) * 12 + (x.month - y.month) + (x.day - y.day) / 31.0

    return Series.from_pylist([do(x, y) for x, y in zip(a, b)],
                              args[0].name, DataType.float64())


@register_kernel("last_day", returns(DataType.date()))
def _last_day(args, **kwargs):
    import calendar
    import datetime as _dt

    def do(v):
        if v is None:
            return None
        d = v.date() if isinstance(v, _dt.datetime) else v
        return _dt.date(d.year, d.month, calendar.monthrange(d.year, d.month)[1])

    return Series.from_pylist([do(v) for v in args[0].to_pylist()],
                              args[0].name, DataType.date())


_DAYNAMES = {"mon": 0, "tue": 1, "wed": 2, "thu": 3, "fri": 4, "sat": 5, "sun": 6}


@register_kernel("next_day", returns(DataType.date()))
def _next_day(args, day: str = "mon", **kwargs):
    import datetime as _dt

    target = _DAYNAMES[day.lower()[:3]]

    def do(v):
        if v is None:
            return None
        d = v.date() if isinstance(v, _dt.datetime) else v
        delta = (target - d.weekday() - 1) % 7 + 1
        return d + _dt.timedelta(days=delta)

    return Series.from_pylist([do(v) for v in args[0].to_pylist()],
                              args[0].name, DataType.date())


@register_kernel("make_date", returns(DataType.date()))
def _make_date(args, **kwargs):
    import datetime as _dt

    ys, ms, ds = (a.to_pylist() for a in args[:3])
    out = [None if None in (y, m, d) else _dt.date(int(y), int(m), int(d))
           for y, m, d in zip(ys, ms, ds)]
    return Series.from_pylist(out, args[0].name, DataType.date())


def _tz_resolver(fields, kwargs):
    dt = fields[0].dtype
    unit = dt.timeunit if dt.id == TypeId.TIMESTAMP else "us"
    return Field(fields[0].name, DataType.timestamp(unit, kwargs.get("timezone")))


@register_kernel("replace_time_zone", _tz_resolver)
def _replace_time_zone(args, timezone=None, **kwargs):
    arr = args[0].to_arrow()
    if not pa.types.is_timestamp(arr.type):
        arr = arr.cast(pa.timestamp("us"))
    if arr.type.tz is not None:
        # Keep the WALL CLOCK, not the instant (a bare cast would keep the
        # UTC instant and silently shift local time).
        naive = pc.local_timestamp(arr)
    else:
        naive = arr
    if timezone is None:
        return _wrap(naive, args[0].name, DataType.timestamp(arr.type.unit))
    out = pc.assume_timezone(naive, timezone)
    return _wrap(out, args[0].name, DataType.timestamp(arr.type.unit, timezone))


@register_kernel("convert_time_zone", _tz_resolver)
def _convert_time_zone(args, timezone="UTC", **kwargs):
    arr = args[0].to_arrow()
    if not pa.types.is_timestamp(arr.type):
        arr = arr.cast(pa.timestamp("us"))
    if arr.type.tz is None:
        arr = pc.assume_timezone(arr, "UTC")
    out = arr.cast(pa.timestamp(arr.type.unit, timezone))
    return _wrap(out, args[0].name, DataType.timestamp(arr.type.unit, timezone))


def _make_ts_resolver(fields, kwargs):
    return Field("timestamp",
                 DataType.timestamp(TimeUnit.US, kwargs.get("timezone")))


@register_kernel("make_timestamp", _make_ts_resolver)
def _make_timestamp(args, timezone=None, **kwargs):
    """(year, month, day, hour, minute, second[, microsecond]) -> Timestamp[us].
    Components are wall-clock time IN the given timezone; fractional seconds
    are honoured; invalid combinations yield null (reference:
    daft/functions/datetime.py make_timestamp)."""
    import datetime as _dt

    tz = None
    if timezone:
        from zoneinfo import ZoneInfo

        tz = _dt.timezone.utc if timezone.upper() == "UTC" else ZoneInfo(timezone)
    cols = [s.to_pylist() for s in args]
    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
    out = []
    for row in zip(*cols):
        if any(v is None for v in row[:6]):
            out.append(None)
            continue
        y, mo, d, h, mi = (int(v) for v in row[:5])
        # Whole micros first so 59.9999999 rounds into the next second
        # instead of overflowing datetime's microsecond argument.
        total_us = int(round(float(row[5]) * 1e6))
        if len(row) > 6 and row[6] is not None:
            total_us += int(row[6])
        sec, us = divmod(total_us, 1_000_000)
        extra_min, sec = divmod(sec, 60)
        try:
            base = _dt.datetime(y, mo, d, h, mi, sec, us, tzinfo=tz)
        except ValueError:
            out.append(None)
            continue
        if extra_min:
            base += _dt.timedelta(minutes=extra_min)
        if tz is None:
            base = base.replace(tzinfo=_dt.timezone.utc)
        # Integer division on the timedelta: total_seconds() is a float and
        # drops the odd microsecond on ~1% of values.
        out.append((base - epoch) // _dt.timedelta(microseconds=1))
    dt = DataType.timestamp(TimeUnit.US, timezone)
    return Series.from_arrow(pa.array(out, pa.int64()).cast(dt.to_arrow()),
                             "timestamp", dt)


# ------------------------------------------------------------------ #
# UUIDv7 partition transforms (reference: daft/functions/partition.py #
# extract_{minute,hour,day,month}_uuid7; src/daft-functions/src/uuid.rs).
# A UUIDv7 embeds a 48-bit unix-ms timestamp in its first 6 bytes.     #
# ------------------------------------------------------------------ #
def _uuid7_ms(v) -> int:
    if isinstance(v, str):
        raw = bytes.fromhex(v.replace("-", "")[:12])
    else:
        raw = bytes(v)[:6]
    return int.from_bytes(raw, "big")


def _register_uuid7(name: str, convert):
    @register_kernel(name, returns(DataType.int64()))
    def _k(args, **kwargs):
        out = [None if v is None else convert(_uuid7_ms(v))
               for v in args[0].to_pylist()]
        return Series.from_pylist(out, args[0].name, DataType.int64())
    return _k


def _months_since_epoch(ms: int) -> int:
    import datetime as _dt

    d = _dt.datetime.fromtimestamp(ms / 1000.0, _dt.timezone.utc)
    return (d.year - 1970) * 12 + (d.month - 1)


_register_uuid7("extract_minute_uuid7", lambda ms: ms // 60_000)
_register_uuid7("extract_hour_uuid7", lambda ms: ms // 3_600_000)
_register_uuid7("extract_day_uuid7", lambda ms: ms // 86_400_000)
_register_uuid7("extract_month_uuid7", _months_since_epoch)


# CURRENT_DATE / CURRENT_TIMESTAMP evaluate at EXECUTION time in UTC (not
# frozen into the plan at parse time), so re-running a cached plan re-reads
# the clock — but the clock is frozen once per query by the runner
# (context.freeze_query_clock), so every micropartition of one statement
# sees the same instant. The single argument is a dummy carrying row count.
@register_kernel("today", returns(DataType.date()))
def _today(args, **kwargs):
    from daft_tpu_torch.context import query_now

    return Series.full(args[0].name, query_now().date(), len(args[0]),
                       DataType.date())


@register_kernel("now", returns(DataType.timestamp("us")))
def _now(args, **kwargs):
    from daft_tpu_torch.context import query_now

    return Series.full(args[0].name, query_now().replace(tzinfo=None),
                       len(args[0]), DataType.timestamp("us"))
