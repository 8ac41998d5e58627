"""iter_ms.chat: mean host ms of one ServingGateway.step() in a chat cell."""
from bench.readers import iter_ms as read  # noqa: F401
