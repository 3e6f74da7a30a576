"""Percent of the traced window in which no operation ran on the card."""

from portbench.readers import idle_share


def read(rec):
    return idle_share(rec)
