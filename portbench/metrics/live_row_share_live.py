"""Live rows stepped over the rows the multiplexer's ticks carried, percent:
live rows (each hop fed to a primed session is stepped in exactly one tick,
and a flush's ticks step only its session) over ``ticks`` x ``slots``, the
ticks from the program's counter ``SessionMultiplexer.ticks``, over the
whole window."""


def read(rec):
    c = rec["counts"]
    if not c.get("ticks"):
        return None
    return 100.0 * c["live_rows"] / (c["ticks"] * c["slots"])
