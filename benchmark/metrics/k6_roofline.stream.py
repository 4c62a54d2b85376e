"""%: the live crops' encoder-block operations at 989 TFLOP/s over K6's
(`vit_blocks`: its GEMM and attention kernels) device time, in the traced
slice."""

from benchlib.readers import k6_roofline as read  # noqa: F401
