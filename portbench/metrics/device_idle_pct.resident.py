"""The traced slice's share of card-time in which no operation ran on a card."""
from portbench.core import idle_pct


def read(rec):
    return idle_pct(rec)
