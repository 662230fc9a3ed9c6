"""The traced slice's share of time in which no operation ran on the device."""
from portbench.core import idle_pct


def read(rec):
    return idle_pct(rec)
