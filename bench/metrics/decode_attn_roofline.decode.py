"""decode_attn_roofline.decode: bound over device time of the paged decode kernels, percent."""
from bench.readers import decode_attn_roofline as read  # noqa: F401
