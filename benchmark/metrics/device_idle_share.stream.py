"""share: 1 - (the union of kernel, memcpy and memset intervals) over the
traced slice's wall time."""

from benchlib.readers import idle_share as read  # noqa: F401
