"""ms/page: device time of the kernels launched inside the program's
`tuatara_recognize` ranges, over the traced slice's pages."""

from benchlib.readers import recognize_ms as read  # noqa: F401
