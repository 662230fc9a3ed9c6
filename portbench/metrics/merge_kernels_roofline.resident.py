"""The traced epochs' merges, every card's groups: their least time at the
HBM rate over the device time of the text and mark kernels on every card."""
from portbench.core import merge_roofline_pct


def read(rec):
    return merge_roofline_pct(rec)
