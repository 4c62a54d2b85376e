"""%: the whole step's share of the card's peak: CRAFT's least time at
peak plus the live crops' PARSeq operations at 989 TFLOP/s, over the
wall time of the untraced window."""

from benchlib.readers import mfu as read  # noqa: F401
