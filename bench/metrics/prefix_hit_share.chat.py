"""prefix_hit_share.chat: percent of admitted prompt tokens whose pages the prefix cache shared."""
from bench.readers import prefix_hit_share as read  # noqa: F401
