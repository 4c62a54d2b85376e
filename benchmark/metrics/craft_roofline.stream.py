"""%: CRAFT's least time at peak (each conv's operations at its stated
precision's peak) over the device time of the kernels launched inside the
benchmark's span around CRAFT's forward, in the traced slice."""

from benchlib.readers import craft_roofline as read  # noqa: F401
