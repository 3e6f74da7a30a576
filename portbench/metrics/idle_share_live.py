"""Percent of the wall time of the calls into the program (spans ``feed`` and
``flush``) in which no operation ran on the card, over the traced slice.
Taken over the calls, not the window: a real-time window waits by design."""

from portbench.readers import idle_share


def read(rec):
    return idle_share(rec, ("feed", "flush"))
