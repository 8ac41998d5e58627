"""mfu.chat: needed model operations over the window, percent of the bf16 peak."""
from bench.readers import mfu as read  # noqa: F401
