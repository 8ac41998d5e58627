"""flash_roofline.chat: bound over device time of the prefill flash kernel, percent."""
from bench.readers import flash_roofline as read  # noqa: F401
