"""cast_share.decode: percent of device busy time in dtype-conversion kernels."""
from bench.readers import cast_share as read  # noqa: F401
