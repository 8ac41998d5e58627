"""idle_share.decode: percent of the traced window with no device operation running."""
from bench.readers import idle_share as read  # noqa: F401
